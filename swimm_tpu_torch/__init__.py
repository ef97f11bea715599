"""swimm_tpu_torch — exact Smith-Waterman protein database search on
PyTorch and CUDA (NVIDIA Hopper).

The PyTorch/CUDA counterpart of the ``swimm_tpu`` package, module for
module: the packed-DB format, the whole-DB resident search path (one launch
per query, or per pack of queries with ``SearchConfig(query_pack=True)``),
the streaming posture for a DB larger than device memory
(``SearchConfig(db_stream=True)``, ``score_db_streaming``), the per-chunk
scoring API ``score_db``, E-value statistics
(``SearchConfig(evalue=True)``), the adaptive-precision ladder
(``SearchConfig(precision='ladder')``) and their five hand-written kernels
(csrc/sw_ragged.cu, csrc/sw_chunk.cu, all on the walk of
csrc/sw_walk_hg.cuh), bit-exact with ``swimm_tpu``. Imports torch and
numpy only. Entry points run on 'cuda' unless given device='cpu'.

  cli / __main__     python -m swimm_tpu_torch {synth,preprocess,search,
                     serve,query,info}
  bench              python -m swimm_tpu_torch.bench: the headline
                     measurement (benchmarks/ holds the others)
  server             SearchServer, Batcher, stdio / TCP / HTTP front ends
  client             the client of a running server (imports no torch)
  models.engine      SearchConfig, search (resident DB, device top-k,
                     device score histograms), score_db (every lane's
                     score, all chunks per launch), score_db_streaming
  models.stream      windows read out of core into pinned slots, a copy
                     stream, the window-major drive loop and its merges
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
  ops.ladder         the precision ladder on the kernels' ceiling variants
  utils.stats        the E-value fit (a copy of swimm_tpu.utils.stats)
  ops.align          alignments of the reported hits (--align, m8): one
                     call a batch -> sw_align_kernel (csrc/sw_align.cu)
                     on a card, ops.traceback.sw_align on the CPU
  ops.traceback      the host traceback (numpy Gotoh with backpointers)
  ops.cref, native   the C reference scorer (--selfcheck) and the C FASTA
                     parser and packer, built from csrc/ by _cc
  db / fasta / ...   packed DB format v1, FASTA, matrices, alphabet
"""

__version__ = "0.1.0"

__all__ = ["build_db", "load_db", "read_fasta", "SearchConfig", "score_db",
           "score_db_streaming", "search"]


def __getattr__(name):
    # lazy re-exports, so that importing a submodule loads no more than it
    # needs: swimm_tpu_torch.client and the CLI's query branch run without
    # torch
    if name in ("build_db", "load_db"):
        from swimm_tpu_torch import db
        return getattr(db, name)
    if name == "read_fasta":
        from swimm_tpu_torch.fasta import read_fasta
        return read_fasta
    if name in ("SearchConfig", "score_db", "score_db_streaming", "search"):
        from swimm_tpu_torch.models import engine
        return getattr(engine, name)
    raise AttributeError(
        f"module 'swimm_tpu_torch' has no attribute {name!r}")
