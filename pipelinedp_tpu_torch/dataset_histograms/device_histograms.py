"""Dataset contribution histograms computed on the card.

Port of pipelinedp_tpu/dataset_histograms/device_histograms.py (K20): the
six contribution histograms of integer-encoded (pid, pk, value) columns.
Three C5 radix sorts order the rows by (pid, pk), by pk, and the pair
starts by pk (invalid rows carry INT32_MAX keys and sink); C17 group_stats
takes the per-pair, per-pid and per-partition statistics from the sorted
streams, reading each sort's sorted first key; C18 log_bins bins them (the
five 3-leading-digit integer histograms in one launch, whose records come
back to the host in one copy, and one float32 histogram of 10,000
equal-width buckets), so only O(bins) values come back to the host.

Semantics are those of the JAX package's device path: the integer
histograms equal the host path (computing_histograms.
compute_dataset_histograms_columnar) bin for bin, with bin sums exact in
int64 (the JAX package's device path sums them in float32, exact while a
bin's sum stays below 2^24); the float histogram bins float32 pair sums on
float32 edges, as the JAX package does, so a sum within float32 rounding of
an edge may land one bucket apart from the float64 host path; its bucket
sums are the float32 of each bucket's float64 sum (the JAX package adds
the float32 values one at a time).

The default device is CUDA and the call raises without it; device="cpu"
runs the kernels' plain versions. Rows must fit one device call.
"""

from typing import Optional

import numpy as np
import torch

from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.dataset_histograms import computing_histograms as ch
from pipelinedp_tpu_torch.dataset_histograms import histograms as hist


def group_stats(pid: torch.Tensor, pk: torch.Tensor,
                values: Optional[torch.Tensor], valid: torch.Tensor):
    """The six stat columns with their masks, {name: (stat, mask)}, each in
    the order of its own sort: C5 three times, C17 three times, each C17
    reading its sort's sorted first key (sorted_top)."""
    pk_sunk = kernels.sunk_keys(pk, valid)
    perm, spid = kernels.radix_sort([kernels.sunk_keys(pid, valid), pk_sunk],
                                    sorted_top=True)
    pairs = kernels.group_stats_pairs(pid, pk, values, valid, perm,
                                      sorted_pid=spid)
    perm2, spk = kernels.radix_sort([pk_sunk], sorted_top=True)
    new_pk, count_per_pk = kernels.group_stats_keys(pk_sunk, valid, perm2,
                                                    sorted_keys=spk)
    pair_pk = pairs["pair_pk"]
    perm3, spk3 = kernels.radix_sort([pair_pk], sorted_top=True)
    new_pk3, pids_per_pk = kernels.group_stats_keys(
        pair_pk, pairs["new_pair"], perm3, sorted_keys=spk3)
    return {
        "l0": (pairs["l0"], pairs["new_pid"]),
        "l1": (pairs["l1"], pairs["new_pid"]),
        "linf": (pairs["pair_len"], pairs["new_pair"]),
        "linf_sum": (pairs["pair_sum"], pairs["new_pair"]),
        "count_per_pk": (count_per_pk, new_pk),
        "pids_per_pk": (pids_per_pk, new_pk3),
    }


def _int_bins_to_histogram(binned, name: hist.HistogramType) -> hist.Histogram:
    lowers, uppers, counts, sums, maxes, n_bins = binned
    k = int(n_bins)
    # Bin bounds are int32 as in the JAX package; a stat within one
    # round_base of 2^31 would wrap its upper bound negative. Every binned
    # stat is a row count, so this is unreachable at one device call's
    # rows; fail loudly rather than emit a corrupt bound.
    uppers_np = uppers[:k].cpu().numpy()
    if k and int(uppers_np.min()) <= 0:
        raise OverflowError(
            f"{name}: log-bin upper bound overflowed int32; stat values "
            "must stay below 2^31 - round_base on the device path")
    bins = [
        hist.FrequencyBin(lower=int(l), upper=int(u), count=int(c),
                          sum=int(s), max=int(m))
        for l, u, c, s, m in zip(lowers[:k].cpu().numpy(), uppers_np,
                                 counts[:k].cpu().numpy(),
                                 sums[:k].cpu().numpy(),
                                 maxes[:k].cpu().numpy())
    ]
    return hist.Histogram(name, bins)


def _float_bins_to_histogram(binned,
                             name: hist.HistogramType) -> hist.Histogram:
    lo_hi, _, counts, sums, maxes = (x.cpu().numpy() for x in binned)
    n_buckets = len(counts)
    lowers = np.linspace(float(lo_hi[0]), float(lo_hi[1]), n_buckets + 1)
    nz = np.nonzero(counts)[0]
    bins = [
        hist.FrequencyBin(lower=float(lowers[i]), upper=float(lowers[i + 1]),
                          count=int(counts[i]), sum=float(sums[i]),
                          max=float(maxes[i])) for i in nz
    ]
    return hist.Histogram(name, bins)


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "compute_dataset_histograms_device runs on a CUDA device and none "
            "is available; pass device='cpu' for the kernels' plain "
            "versions.")
    return dev


def device_columns(pids, pks, values, device):
    """The padded columns on the device: rows padded to a power of two (at
    least 8) as the JAX package pads them, pad rows invalid."""
    pids = np.asarray(pids)
    pks = np.asarray(pks)
    n = len(pids)
    cap = max(8, 1 << (n - 1).bit_length()) if n else 8
    pad = cap - n

    def padded(a, dtype, fill=0):
        return torch.from_numpy(np.pad(np.asarray(a).astype(dtype), (0, pad),
                                       constant_values=fill)).to(device)

    vals = None if values is None else padded(values, np.float32)
    return (padded(pids, np.int32), padded(pks, np.int32), vals,
            padded(np.ones(n, bool), bool, False))


def compute_dataset_histograms_device(
        pids: np.ndarray,
        pks: np.ndarray,
        values: Optional[np.ndarray] = None,
        device=None) -> hist.DatasetHistograms:
    """All six dataset histograms from integer-encoded columns, on the card
    (device: default CUDA, raising without it; "cpu" for the plain
    versions). Same semantics as the JAX package's
    compute_dataset_histograms_device."""
    dev = _resolve_device(device)
    pid, pk, vals, valid = device_columns(pids, pks, values, dev)
    stats = group_stats(pid, pk, vals, valid)
    T = hist.HistogramType
    names = (("l0", T.L0_CONTRIBUTIONS), ("l1", T.L1_CONTRIBUTIONS),
             ("linf", T.LINF_CONTRIBUTIONS),
             ("count_per_pk", T.COUNT_PER_PARTITION),
             ("pids_per_pk", T.COUNT_PRIVACY_ID_PER_PARTITION))
    # The five integer histograms: one C18 launch, one copy to the host.
    binned = kernels.log_bins_int_unpack(kernels.log_bins_int_many(
        [stats[key] for key, _ in names]).cpu())
    ints = {key: _int_bins_to_histogram(b, name)
            for (key, name), b in zip(names, binned)}
    linf_sum = None
    if values is not None:
        linf_sum = _float_bins_to_histogram(
            kernels.log_bins_float(
                *stats["linf_sum"],
                ch.NUMBER_OF_BUCKETS_IN_LINF_SUM_CONTRIBUTIONS_HISTOGRAM),
            T.LINF_SUM_CONTRIBUTIONS)
    return hist.DatasetHistograms(ints["l0"], ints["l1"], ints["linf"],
                                  linf_sum, ints["count_per_pk"],
                                  ints["pids_per_pk"])
