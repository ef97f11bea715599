"""swimm_tpu_torch — exact Smith-Waterman protein database search on
PyTorch and CUDA (NVIDIA Hopper).

The PyTorch/CUDA counterpart of the ``swimm_tpu`` package, module for
module: the packed-DB format, the whole-DB resident search path (one launch
per query, or per pack of queries with ``SearchConfig(query_pack=True)``),
the per-chunk scoring API ``score_db`` and their five hand-written kernels
(csrc/sw_ragged.cu, csrc/sw_chunk.cu over the strip walks of
csrc/sw_walk_hg.cuh and, for sw_chunk_qtile_kernel, csrc/sw_walk.cuh),
bit-exact with ``swimm_tpu``. Imports torch and numpy only. Entry points run
on 'cuda' unless given device='cpu'.

  cli / __main__     python -m swimm_tpu_torch {synth,preprocess,search}
  models.engine      SearchConfig, search (resident DB, device top-k),
                     score_db (every lane's score, all chunks per launch)
  models.qpack       build_query_packs (many queries in one profile)
  ops.scorer         score_tiles        -> sw_ragged_kernel
                     score_tiles_packed -> sw_ragged_packed_kernel
                     score_chunks       -> sw_chunk_kernel (a list of chunks
                                           per launch; score_chunk is its
                                           one-chunk case)
  ops.longquery      score_tiles_long   -> sw_ragged_qtile_kernel
                     score_chunks_long  -> sw_chunk_qtile_kernel (a list of
                                           chunks per launch; score_chunk_long
                                           is its one-chunk case)
  db / fasta / ...   packed DB format v1, FASTA, matrices, alphabet
"""

__version__ = "0.1.0"

from swimm_tpu_torch.db import build_db, load_db
from swimm_tpu_torch.fasta import read_fasta
from swimm_tpu_torch.models.engine import SearchConfig, score_db, search

__all__ = ["build_db", "load_db", "read_fasta", "SearchConfig", "score_db",
           "search"]
