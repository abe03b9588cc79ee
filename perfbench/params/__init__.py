"""The weights of a configuration of another family than the DiT: a module
`<name>.py` a configuration names under `weights`, with a
`make_params(cfg, seed, device)` that draws them on the device from the
seed, in the port's layout (see `weights.py`)."""
