"""swimm_tpu_torch — exact Smith-Waterman protein database search on
PyTorch and CUDA (NVIDIA Hopper).

The PyTorch/CUDA counterpart of the ``swimm_tpu`` package, module for
module: the packed-DB format, the whole-DB resident search path and its two
kernels (csrc/sw_ragged.cu), bit-exact with ``swimm_tpu``. Imports torch
and numpy only. Entry points run on 'cuda' unless given device='cpu'.

  cli / __main__     python -m swimm_tpu_torch {synth,preprocess,search}
  models.engine      SearchConfig, search (resident DB, device top-k)
  ops.scorer         score_tiles      -> sw_ragged_kernel
  ops.longquery      score_tiles_long -> sw_ragged_qtile_kernel
  db / fasta / ...   packed DB format v1, FASTA, matrices, alphabet
"""

__version__ = "0.1.0"

from swimm_tpu_torch.db import build_db, load_db
from swimm_tpu_torch.fasta import read_fasta
from swimm_tpu_torch.models.engine import SearchConfig, search

__all__ = ["build_db", "load_db", "read_fasta", "SearchConfig", "search"]
