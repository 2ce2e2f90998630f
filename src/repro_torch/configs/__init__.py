"""Workload configurations shared by the port's build, tests and smoke run."""
