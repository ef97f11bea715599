"""The out-of-core batch screen (``swimm_tpu_torch search --stream`` of a
query file): the batch driver's closed loop of back-to-back
``engine.search`` calls, over the pack as ``search --stream`` opens it,
``load_db`` with its chunk files memmapped, so that each window is read
from the files by the stream's reader thread.

The result line's counters add the program's own count of the windows
streamed in the measured window and of the bytes they copied to the
card, where the program keeps such counters.
"""

from __future__ import annotations

from swbench.drivers import batch

#: the program's counters (models/stream.py) -> the result line's names
COUNTERS = {"windows": "stream_windows", "h2d_bytes": "stream_h2d_bytes"}


def _program_counts() -> dict:
    """The stream's counters as they stand; {} for a program without
    them."""
    from swimm_tpu_torch.models import stream
    return {k: getattr(stream.stream_windows, k) for k in COUNTERS
            if isinstance(getattr(stream.stream_windows, k, None), int)}


class Session(batch.Session):
    def __init__(self, cfg, traffic, db, packed, device, seed, seconds,
                 spans, workdir):
        from swimm_tpu_torch.db import load_db
        super().__init__(cfg, traffic, db, load_db(workdir / "pack"),
                         device, seed, seconds, spans, workdir)

    def window(self) -> batch.Window:
        before = _program_counts()
        win = super().window()
        after = _program_counts()
        win.counters.update({COUNTERS[k]: after[k] - before[k]
                             for k in before})
        return win
