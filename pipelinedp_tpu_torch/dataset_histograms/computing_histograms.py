"""Computing dataset histograms on the host.

Port of pipelinedp_tpu/dataset_histograms/computing_histograms.py: the
log binning (``_to_bin_lower_upper_logarithmic`` and its vectorized form),
the frequency and float histograms, and the pure-columnar entry point
``compute_dataset_histograms_columnar``, numpy over whole columns. The
collection pipeline of that module (``compute_dataset_histograms`` and the
pre-aggregated variants) runs on the generic backends, which the port does
not have yet (ROADMAP.md Queue 1 item 14).
"""

from typing import Optional, Tuple

import numpy as np

from pipelinedp_tpu_torch.dataset_histograms import histograms as hist

NUMBER_OF_BUCKETS_IN_LINF_SUM_CONTRIBUTIONS_HISTOGRAM = 10000


def _to_bin_lower_upper_logarithmic(value: int) -> Tuple[int, int]:
    """Log-ish binning keeping 3 leading digits (reference ``:28-47``).

    123 -> [123,124), 1234 -> [1230,1240), 12345 -> [12300,12400); exact
    powers-of-10 boundary values get a bin of the next width. Keep in sync
    with private_contribution_bounds.generate_possible_contribution_bounds.
    """
    bound = 1000
    while value > bound:
        bound *= 10
    round_base = bound // 1000
    lower = value // round_base * round_base
    bin_size = round_base if value != bound else round_base * 10
    return lower, lower + bin_size


def _bin_lowers_log_vectorized(
        values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized _to_bin_lower_upper_logarithmic over an int array."""
    values = np.asarray(values, dtype=np.int64)
    # bound = smallest power-of-10 multiple of 1000 that is >= value
    # i.e. bound = 1000 * 10^max(0, ceil(log10(value/1000)))
    safe = np.maximum(values, 1).astype(np.float64)
    exp = np.ceil(np.log10(safe / 1000.0))
    exp = np.maximum(exp, 0).astype(np.int64)
    bound = 1000 * np.power(10, exp)
    # float log10 can land one decade off at exact boundaries; correct it.
    bound = np.where(bound < values, bound * 10, bound)
    bound_down = bound // 10
    bound = np.where((bound_down >= 1000) & (bound_down >= values),
                     bound_down, bound)
    round_base = bound // 1000
    lower = values // round_base * round_base
    bin_size = np.where(values != bound, round_base, round_base * 10)
    return lower, lower + bin_size


def _frequencies_to_histogram(values: np.ndarray,
                              frequencies: np.ndarray,
                              name: hist.HistogramType) -> hist.Histogram:
    """Builds a log-binned integer Histogram from (value, frequency) columns.

    Vectorized equivalent of the reference's map→reduce_per_key chain
    (``computing_histograms.py:105-195``).
    """
    values = np.asarray(values, dtype=np.int64)
    frequencies = np.asarray(frequencies, dtype=np.int64)
    if values.size == 0:
        return hist.Histogram(name, [])
    lowers, uppers = _bin_lowers_log_vectorized(values)
    uniq_lowers, inverse = np.unique(lowers, return_inverse=True)
    counts = np.bincount(inverse, weights=frequencies)
    sums = np.bincount(inverse, weights=frequencies * values)
    # per-bin max of values and the bin upper
    maxes = np.zeros(uniq_lowers.size, dtype=np.int64)
    np.maximum.at(maxes, inverse, values)
    bin_uppers = np.zeros(uniq_lowers.size, dtype=np.int64)
    np.maximum.at(bin_uppers, inverse, uppers)
    bins = [
        hist.FrequencyBin(lower=int(l), upper=int(u), count=int(c),
                          sum=int(s), max=int(m))
        for l, u, c, s, m in zip(uniq_lowers, bin_uppers, counts, sums, maxes)
    ]
    return hist.Histogram(name, bins)


def _float_values_to_histogram(values: np.ndarray,
                               name: hist.HistogramType,
                               number_of_buckets: int = None
                               ) -> hist.Histogram:
    """Equal-width float histogram between min and max (reference ``:314-362``)."""
    if number_of_buckets is None:
        number_of_buckets = (
            NUMBER_OF_BUCKETS_IN_LINF_SUM_CONTRIBUTIONS_HISTOGRAM)
    values = np.asarray(values, dtype=np.float64)
    if values.size == 0:
        return hist.Histogram(name, [])
    lo, hi = float(values.min()), float(values.max())
    lowers = np.linspace(lo, hi, number_of_buckets + 1)
    idx = np.searchsorted(lowers, values, side='right') - 1
    idx = np.clip(idx, 0, number_of_buckets - 1)
    uniq_idx, inverse = np.unique(idx, return_inverse=True)
    counts = np.bincount(inverse)
    sums = np.bincount(inverse, weights=values)
    maxes = np.full(uniq_idx.size, -np.inf)
    np.maximum.at(maxes, inverse, values)
    bins = [
        hist.FrequencyBin(lower=float(lowers[i]), upper=float(lowers[i + 1]),
                          count=int(c), sum=float(s), max=float(m))
        for i, c, s, m in zip(uniq_idx, counts, sums, maxes)
    ]
    return hist.Histogram(name, bins)


def _unique_pairs(pids: np.ndarray, pks: np.ndarray):
    """np.unique of the (pid, pk) rows, in their lexicographic order, with
    the inverse. Each column is factorized on its own, and the pairs are
    grouped by one int64 key, pid code * #pks + pk code, which orders them
    as the rows would sort."""
    upids, pid_codes = np.unique(pids, return_inverse=True)
    upks, pk_codes = np.unique(pks, return_inverse=True)
    n_pks = max(upks.size, 1)
    key = pid_codes.reshape(-1).astype(np.int64) * n_pks + pk_codes.reshape(-1)
    uniq, inverse = np.unique(key, return_inverse=True)
    return (np.stack([upids[uniq // n_pks], upks[uniq % n_pks]], axis=1),
            inverse.reshape(-1))


def compute_dataset_histograms_columnar(
        pids: np.ndarray,
        pks: np.ndarray,
        values: Optional[np.ndarray] = None) -> hist.DatasetHistograms:
    """All six histograms from columnar (pid, pk, value) arrays in one pass
    on the host: np.unique / bincount over whole columns. The oracle the
    device path (device_histograms) is held to."""
    pids = np.asarray(pids)
    pks = np.asarray(pks)
    has_values = values is not None
    if not has_values:
        values = np.zeros(pids.shape[0], dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)

    # group by (pid, pk): contributions count + sum per pair
    pair_codes, pair_inverse = _unique_pairs(pids, pks)
    pair_counts = np.bincount(pair_inverse)
    pair_sums = np.bincount(pair_inverse, weights=values)
    pair_pids = pair_codes[:, 0]
    pair_pks = pair_codes[:, 1]

    # L0: #distinct partitions per pid
    _, l0_per_pid = np.unique(pair_pids, return_counts=True)
    # L1: #records per pid
    _, l1_per_pid = np.unique(pids, return_counts=True)
    # partition stats
    _, count_per_pk = np.unique(pks, return_counts=True)
    _, pid_count_per_pk = np.unique(pair_pks, return_counts=True)

    def int_hist(values_, name):
        uniq, freq = np.unique(values_, return_counts=True)
        return _frequencies_to_histogram(uniq, freq, name)

    return hist.DatasetHistograms(
        int_hist(l0_per_pid, hist.HistogramType.L0_CONTRIBUTIONS),
        int_hist(l1_per_pid, hist.HistogramType.L1_CONTRIBUTIONS),
        int_hist(pair_counts, hist.HistogramType.LINF_CONTRIBUTIONS),
        _float_values_to_histogram(
            pair_sums, hist.HistogramType.LINF_SUM_CONTRIBUTIONS)
        if has_values else None,
        int_hist(count_per_pk, hist.HistogramType.COUNT_PER_PARTITION),
        int_hist(pid_count_per_pk,
                 hist.HistogramType.COUNT_PRIVACY_ID_PER_PARTITION),
    )
