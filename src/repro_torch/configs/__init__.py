"""Architecture configurations (copies of ``repro.configs`` for the ported
families)."""
