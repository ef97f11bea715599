"""How each deployment is brought up and driven; a configuration names its
driver (``"driver"``) and spec.Spec finds ``drivers/<driver>.py``. A driver
module defines ``Session(cfg, traffic, db, packed, device, seed, seconds,
spans, workdir)`` with ``setup()``, ``window() -> Window``, ``label(t)``
and ``close()``."""
