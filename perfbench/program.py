"""The benchmark's adapter to the program under test, the port
`repro_torch`: builds the engine a configuration file describes through
the port's own entry point (`launch/sample.py:build_engine`) and the
UniPC spec a traffic file describes. The only module of the benchmark
that the drivers take the program from."""

from __future__ import annotations

from . import harness


def import_port() -> None:
    """Import the port's modules the drivers use (set-up times it apart)."""
    import repro_torch.engine  # noqa: F401
    import repro_torch.launch.sample  # noqa: F401
    import repro_torch.serving.scheduler  # noqa: F401


def engine(cfg: dict, params: dict, batch: int, seed: int, quant: str,
           device):
    """The port's SamplerEngine over the configuration, with per-call
    class ids for a conditional model."""
    from repro_torch.diffusion.schedules import VPLinear
    from repro_torch.launch.sample import build_engine

    return build_engine(harness.port_config(cfg), params, VPLinear(),
                        batch=batch, seed=seed,
                        per_request_cond=bool(cfg["conditional"]),
                        quant=quant, device=device)


def spec(cfg: dict, traffic: dict, quant: str, w_nominal=None):
    """The UniPC EngineSpec of the traffic's solver. `w_nominal` is a DiT
    guidance scale (eps_u + w (eps_c - eps_u)); the port's scale g weighs
    (1 + g) eps_c - g eps_u, so g = w - 1."""
    from repro_torch.engine import EngineSpec

    s = traffic["solver"]
    sched = s["schedule"]
    if (s["solver"], sched["kind"], sched["beta_0"], sched["beta_1"],
            sched["T"], sched["t_eps"]) != ("unipc", "vp_linear", 0.1,
                                            20.0, 1.0, 1e-3):
        raise ValueError("the port's engine samples UniPC over VPLinear() "
                         "(beta 0.1 to 20, T 1, t_eps 1e-3) only")
    g = (w_nominal - 1.0) if (cfg["conditional"] and w_nominal) else 0.0
    return EngineSpec(solver="unipc", nfe=s["nfe"], order=s["order"],
                      variant=s["variant"], prediction="data",
                      spacing=s["spacing"],
                      lower_order_final=s["lower_order_final"],
                      cfg_scale=g, quant=quant)
