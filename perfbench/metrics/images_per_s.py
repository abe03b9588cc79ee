"""images_per_s: the latents that reached the host in the window over the
window's seconds, all of them."""


def read(run):
    return run.images / run.window_s if run.images else None
