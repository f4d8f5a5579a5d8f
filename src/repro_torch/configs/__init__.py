"""Published configurations, copied from ``repro.configs``."""
