"""The frozen speed of light of Smith-Waterman/Gotoh on one NVIDIA H100 SXM,
per real cell (query residue x database residue; padding is no cell).

It is independent of any implementation, and no exact one can pass it:

- a cell of the recurrence needs four add-max operations: E (gap in the
  query), F (gap in the database sequence), H with its substitution score,
  and the running best;
- the densest lane form sm_90 executes natively is a pair of 16-bit lanes
  in one 32-bit thread-instruction, so the four take 2 thread-instructions
  a cell;
- the card issues at most 132 SMs x 128 thread-instructions a clock (4
  sub-partitions of 32 lanes) x 1,980 MHz = 33.45e12 a second;
- so at most 33.45e12 / 2 = 16,727 GCUPS.

The byte bound does not bind: the database's 1-byte codes, read once per
query pass at 3.35 TB/s, take 62 us for Swiss-Prot's 2e8 residues, against
at least 5 ms of compute for the shortest canonical query.

Nothing here reads the program's own counts (its SASS, its instructions
per cell, its padded cells).
"""

from __future__ import annotations

SMS = 132
THREAD_INSTR_PER_SM_CLOCK = 128
CLOCK_HZ = 1.980e9
ISSUE_PER_S = SMS * THREAD_INSTR_PER_SM_CLOCK * CLOCK_HZ     # 33.45e12
ADD_MAX_PER_CELL = 4
LANES_PER_INSTR = 2                                          # 16-bit pairs
INSTR_PER_CELL = ADD_MAX_PER_CELL / LANES_PER_INSTR          # 2
CELLS_PER_S = ISSUE_PER_S / INSTR_PER_CELL                   # 16.727e12
HBM_BYTES_PER_S = 3.35e12


def seconds(cells: int, db_bytes: int = 0) -> float:
    """The least time the card can take for ``cells`` real cells that read
    ``db_bytes`` bytes of database codes: the larger of the two bounds."""
    return max(cells / CELLS_PER_S, db_bytes / HBM_BYTES_PER_S)


def check_card(sm_count: int) -> None:
    """Raise unless the card has the SM count these constants assume."""
    if sm_count != SMS:
        raise RuntimeError(f"the speed of light is frozen for {SMS} SMs; "
                           f"this card has {sm_count}")
