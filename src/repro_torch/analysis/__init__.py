"""The analysis layer for one card (the port of `repro.analysis`): the
H100 roofline (`roofline.py`) and the operation and byte count of an eager
run (`opcount.py`, the counterpart of the reference's HLO accounting)."""
