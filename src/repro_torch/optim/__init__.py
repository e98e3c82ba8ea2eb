"""Optimizers (AdamW, Adafactor) over the port's parameter trees, and
int8 gradient compression with error feedback."""
