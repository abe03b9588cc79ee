"""What a configuration of the port's hybrid family brings the benchmark,
as `perfbench/README.md` lists it, laid out as the benchmark's own
packages: `params/`, `reference/` and `bounds/`. The CPU proof points
the lookups here (`harness.PACKAGES`). A fixture, not a cell's reference,
may use the port's layout and its plain fp32 eps-net."""
