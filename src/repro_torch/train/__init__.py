"""Training on one device: AdamW (``optimizer``), the train step and loop
(``loop``) and checkpoints in the reference's format (``checkpoint``).
Import-light: nothing is imported here."""
