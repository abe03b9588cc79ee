"""The plain references the benchmark holds the program against: fp32
PyTorch (TF32 off) from the published equations. Nothing here imports the
program or reads what it made."""
