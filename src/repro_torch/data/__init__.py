"""The deterministic, resumable token pipeline (`pipeline`)."""
