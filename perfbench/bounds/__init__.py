"""Roofline bounds a roofline's `.json` names as `<module>:<function>`: a
module `<module>.py` whose functions take (cfg, rows, evals) and return
the least seconds of that kernel family's work, from shapes, as
`yardstick.py`'s do."""
