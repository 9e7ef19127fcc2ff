"""PlexRL core in PyTorch: Router + worker-process groups + StateManager
over the HRRS scheduler (a copy of ``repro.core.scheduler``)."""
