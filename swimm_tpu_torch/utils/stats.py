"""Empirical E-value statistics for local-alignment scores (a copy of
swimm_tpu/utils/stats.py: numpy only, run on the host, so both packages
fit the same null model from the same integer table bit for bit).

Extension beyond the reference: SWIMM reports raw Smith-Waterman scores
only (SURVEY.md section 3 C13 — "rank scores, resolve titles"); judging
biological significance is left to the user. Production search tools
(FASTA/SSEARCH) attach an expectation value to every hit. This module
implements that the way SSEARCH does for *gapped* scores — where the
analytic Karlin-Altschul K/lambda do not apply — by fitting the score
distribution of the search itself:

1.  Extreme-value theory: the optimal local alignment score of a random
    (query, subject) pair follows a Gumbel distribution whose location
    grows linearly in ln(subject length) (Karlin-Altschul asymptotics).
2.  Robust fit: least-squares regression score ~ a + b*ln(len) over all
    database sequences, iteratively censoring high outliers (true
    homologs live in the right tail and must not bias the null model —
    the same censored-fit idea as FASTA's maximum-likelihood Zscore
    estimation, re-derived here from scratch).
3.  Gumbel scale from the trimmed residual spread via the method of
    moments: sd = beta*pi/sqrt(6), mean = gamma*beta (gamma =
    Euler-Mascheroni), so a score s against a length-l sequence has
        P(S >= s) = 1 - exp(-exp(-(s - a - b*ln(l) - mu)/beta))
    and E = n_db * P — the expected number of database sequences
    reaching s by chance alone.

Everything is estimated from the data: no precomputed K/lambda tables,
so the statistics stay honest for any matrix / gap-penalty combination
the engine accepts (including ones no published table covers).

The fit consumes the full per-sequence score vector, which the
full-vector path (engine.score_db) already produces in sorted-db order
alongside PackedDb.lengths. Cost: one (n_seqs,) int32 fetch plus O(n)
host arithmetic — microseconds at Swiss-Prot scale next to the scoring
itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_EULER_GAMMA = 0.5772156649015329
# minimum surviving fraction: if censoring would discard more than half
# the database the "null" fit would be fitting the homologs instead
_MIN_KEEP_FRAC = 0.5


@dataclass
class EValueModel:
    """Null model for one query against one database."""
    a: float            # regression intercept: E[S] at ln(len) = 0
    b: float            # regression slope vs ln(subject length)
    mu: float           # Gumbel location of the residuals
    beta: float         # Gumbel scale of the residuals
    n_db: int           # database size the expectation refers to
    n_censored: int     # sequences censored as right-tail outliers
    n_iters: int        # censoring iterations until stable

    def surprise(self, score, length) -> np.ndarray:
        """Standardized Gumbel deviate u; P(S >= s) = 1 - exp(-exp(-u))."""
        ln_l = np.log(np.maximum(np.asarray(length, np.float64), 1.0))
        s = np.asarray(score, np.float64)
        return (s - self.a - self.b * ln_l - self.mu) / max(self.beta, 1e-9)

    def pvalue(self, score, length) -> np.ndarray:
        """Per-pair tail probability, numerically stable in both tails."""
        u = self.surprise(score, length)
        # 1 - exp(-exp(-u)) == -expm1(-exp(-u)): exact for tiny exp(-u)
        # (large scores), saturates to 1.0 for deep-left u — both correct
        return -np.expm1(-np.exp(-u))

    def evalue(self, score, length) -> np.ndarray:
        """Expected chance hits >= score in a database of n_db seqs."""
        return self.n_db * self.pvalue(score, length)


def _fit_censored(x: np.ndarray, s: np.ndarray, w: np.ndarray,
                  max_iters: int = 10):
    """Weighted censored fit shared by the full-vector and histogram
    paths: iterative weighted least squares of s ~ a + b*x with
    right-tail censoring (residual > 3 sd), then Gumbel moments on the
    surviving weighted residuals. w is the multiplicity of each (x, s)
    point (1.0 for raw vectors; bin counts for histograms)."""
    n_total = float(w.sum())
    keep = np.ones(s.size, bool)
    min_keep = max(8.0, _MIN_KEEP_FRAC * n_total)
    a = b = 0.0
    iters = 0
    while True:
        iters += 1
        wk = w * keep
        n = wk.sum()
        xm = (wk * x).sum() / n
        sm = (wk * s).sum() / n
        var = (wk * (x - xm) ** 2).sum() / n
        b = 0.0 if var < 1e-12 else \
            (wk * (x - xm) * (s - sm)).sum() / n / var
        a = sm - b * xm
        resid = s - (a + b * x)
        sd = max(float(np.sqrt((wk * resid ** 2).sum() / n
                               - ((wk * resid).sum() / n) ** 2)), 1e-9)
        new_keep = keep & (resid <= 3.0 * sd)
        # break BEFORE adopting new_keep when done, so the returned
        # moments are always computed on the set (a, b) was fitted on
        if (iters >= max_iters
                or (w * new_keep).sum() < min_keep
                or bool((new_keep == keep).all())):
            break
        keep = new_keep
    wk = w * keep
    n = wk.sum()
    resid = s - (a + b * x)
    rm = (wk * resid).sum() / n
    sd = max(float(np.sqrt((wk * resid ** 2).sum() / n - rm ** 2)), 1e-9)
    beta = sd * np.sqrt(6.0) / np.pi
    mu = rm - _EULER_GAMMA * beta
    return (float(a), float(b), float(mu), float(beta),
            int(round(n_total - (w * keep).sum())), iters)


def attach_evalues(hits, model: EValueModel, lengths: np.ndarray) -> None:
    """Annotate engine Hit objects in place: hit.evalue from the fitted
    null model and the subject's true length (lengths: per sequence in
    sorted-db order, i.e. PackedDb.lengths), plus hit.bits — the bit
    score under the SAME fitted model via the standard inversion
    E = n_db * 2^(-bits), i.e. bits = surprise / ln 2 (the empirical
    analog of BLAST's (lambda*S - ln K)/ln 2; exact for the fitted
    Gumbel instead of a precomputed K/lambda table — the m8 format's
    column 12). One definition for every serving posture's drain loop."""
    for h in hits:
        li = int(lengths[h.sorted_idx])
        h.evalue = float(model.evalue(h.score, li))
        h.bits = float(model.surprise(h.score, li)) / float(np.log(2.0))


def fit_evalue_model(scores: np.ndarray, lengths: np.ndarray,
                     max_iters: int = 10) -> EValueModel:
    """Fit the null model from one query's full score vector.

    scores/lengths: per database sequence, any matching order. The fit
    censors right-tail outliers (residual > 3 sd) iteratively so planted
    or real homologs do not inflate the null — censoring only the RIGHT
    tail is deliberate: low scores are legitimate null draws.
    """
    s = np.asarray(scores, np.float64).ravel()
    x = np.log(np.maximum(np.asarray(lengths, np.float64).ravel(), 1.0))
    if s.shape != x.shape:
        raise ValueError(f"scores {s.shape} vs lengths {x.shape}")
    if s.size < 8:
        raise ValueError(f"need >= 8 sequences to fit statistics "
                         f"(got {s.size})")
    a, b, mu, beta, n_cens, iters = _fit_censored(
        x, s, np.ones_like(s), max_iters)
    return EValueModel(a=a, b=b, mu=mu, beta=beta, n_db=s.size,
                       n_censored=n_cens, n_iters=iters)


# ---------------------------------------------------------------------
# Histogram (device-side sufficient statistics) path: the fused serving
# step bins sequences by ln(length) and accumulates a per-query unit-
# score histogram ON DEVICE (one torch.bincount, engine.score_hist) — only
# the (n_bins, n_scores) count table comes to the host, not the (n_seqs,)
# vector.
# ---------------------------------------------------------------------

N_LEN_BINS = 32      # ln-length resolution of the binned fit
SCORE_CAP = 511      # scores clip here on device; anything this high is
# far outside the null right-tail cut and lands in the censored set, so
# clipping cannot perturb the surviving fit


def lane_bin_map(mask: np.ndarray, lane2sorted: np.ndarray,
                 lengths: np.ndarray) -> np.ndarray:
    """Per-LANE ln-length bin ids (int32) over a flat lane order: bin of
    a valid lane = its sequence's length bin; pad lanes read bin 0 and
    must carry weight 0 through the mask. One definition shared by the
    streaming and sharded-streaming seg maps (deterministic from the
    packed DB, so every host builds the identical array)."""
    bin_ids, _ = length_bins(lengths)
    return np.where(mask, bin_ids[lane2sorted], 0).astype(np.int32)


def length_bins(lengths: np.ndarray, n_bins: int = N_LEN_BINS):
    """Per-sequence ln-length bin ids + each bin's mean ln(length).

    Bins are equal-width in ln(l) over the observed range; empty bins
    get weight 0 in the fit, so their placeholder center is irrelevant.
    """
    ln_l = np.log(np.maximum(np.asarray(lengths, np.float64), 1.0))
    lo, hi = float(ln_l.min()), float(ln_l.max())
    width = max((hi - lo) / n_bins, 1e-9)
    ids = np.minimum(((ln_l - lo) / width).astype(np.int32), n_bins - 1)
    centers = np.zeros(n_bins)
    counts = np.bincount(ids, minlength=n_bins)
    sums = np.bincount(ids, weights=ln_l, minlength=n_bins)
    nz = counts > 0
    centers[nz] = sums[nz] / counts[nz]
    return ids, centers


def fit_evalue_model_hist(hist: np.ndarray, bin_logl: np.ndarray,
                          max_iters: int = 10) -> EValueModel:
    """Fit the null model from a (n_bins, n_scores) count table.

    hist[b, s] = number of database sequences in ln-length bin b whose
    score is s (clipped at the table edge). Identical estimator to
    fit_evalue_model up to the ln-length discretization (each member
    uses its bin's mean ln(l) as the regressor — <1% slope error at 32
    bins over a 40x length range)."""
    hist = np.asarray(hist, np.float64)
    n_bins, n_scores = hist.shape
    n_db = float(hist.sum())
    if n_db < 8:
        raise ValueError(f"need >= 8 sequences to fit statistics "
                         f"(got {int(n_db)})")
    cells = np.nonzero(hist > 0)
    x = np.asarray(bin_logl, np.float64)[cells[0]]
    s = cells[1].astype(np.float64)
    w = hist[cells]
    a, b, mu, beta, n_cens, iters = _fit_censored(x, s, w, max_iters)
    # saturation guard: scores clip at the table edge, which is only
    # harmless while everything in the top column would have been
    # censored anyway (right-tail outliers). If the fitted null says the
    # edge is NOT deep in the right tail of some populated bin, the clip
    # has corrupted the fit — fail loudly rather than report silently
    # anti-conservative E-values (reachable with degenerate gap
    # penalties, e.g. gap_open=gap_extend=0, where null scores blow past
    # the table edge).
    top = hist[:, -1]
    if top.sum() > 0:
        sd = beta * np.pi / np.sqrt(6.0)
        resid_edge = (n_scores - 1) - (a + b * np.asarray(bin_logl))
        bad = (top > 0) & (resid_edge <= 3.0 * sd)
        if top.sum() > 0.02 * n_db or bool(bad.any()):
            raise ValueError(
                "score histogram saturated: the null score distribution "
                "reaches the device histogram's top bin, so binned "
                "E-value statistics would be corrupted. This happens "
                "with degenerate scoring parameters (e.g. zero gap "
                "penalties); use realistic penalties, or the full-vector "
                "statistics path (precision='ladder')")
    return EValueModel(a=a, b=b, mu=mu, beta=beta, n_db=int(n_db),
                       n_censored=n_cens, n_iters=iters)
