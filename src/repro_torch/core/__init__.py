"""The container count and its accounting: the workload splitter, the
paper's energy/time models, the online ``DivideAndSaveScheduler`` and
the container budgets, beside the host-side harness of the port's
process containers. Import-light: spawned children import this package
before they apply their cpuset, so nothing is imported here."""
