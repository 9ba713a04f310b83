"""Adapters from a configuration's `entry` name to the program's entry point
that the measured window drives."""
