"""Launch-time checks (port of ``repro.launch``): ``dryrun``."""
