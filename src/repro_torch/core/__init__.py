"""Host-side harness shared by the port's process containers (import-light:
spawned children import it before they apply their cpuset)."""
