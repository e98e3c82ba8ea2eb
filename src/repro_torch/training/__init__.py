"""The train step, the eval step and the straggler watchdog (`step`)."""
