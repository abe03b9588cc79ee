"""Synthetic training data (numpy only): the port's copy of `repro.data`."""
