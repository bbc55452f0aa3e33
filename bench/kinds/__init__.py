"""Drivers of the configuration kinds: ``<kind>.py`` builds the program's
training job for a configuration whose file says ``"kind": "<kind>"``."""
