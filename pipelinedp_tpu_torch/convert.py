"""State carried across from the JAX package, at the numpy level.

These functions turn the kernel inputs of pipelinedp_tpu, once extracted to
numpy arrays and plain Python values, into the port's, so one state can be
fed to both packages: the encoded columns, the KernelConfig fields, the
noise stds, the SelectionParams fields, the uint32[2] threefry key and a
privacy loss distribution's fields; and either package's dataset
histograms into plain tuples for comparison. Nothing here imports the JAX
package; the caller does the extracting (e.g. `dataclasses.asdict` of its
KernelConfig).
"""

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch import columnar
from pipelinedp_tpu_torch import executor
from pipelinedp_tpu_torch.accounting import pld as pldlib
from pipelinedp_tpu_torch.aggregate_params import NoiseKind, NormKind
from pipelinedp_tpu_torch.ops import selection_ops

def encoded_data(pid: np.ndarray, pk: np.ndarray, values: np.ndarray,
                 partition_vocab: Sequence[Any], n_privacy_ids: int,
                 public_encoded: bool = False) -> columnar.EncodedData:
    """The JAX package's EncodedData arrays as the port's EncodedData."""
    return columnar.EncodedData(
        pid=np.asarray(pid, dtype=np.int32),
        pk=np.asarray(pk, dtype=np.int32),
        values=np.asarray(values, dtype=np.float64),
        partition_vocab=partition_vocab,
        n_privacy_ids=int(n_privacy_ids),
        public_encoded=bool(public_encoded))


def selection_params(fields: Mapping[str, Any]) -> selection_ops.SelectionParams:
    """SelectionParams from the JAX package's SelectionParams fields."""
    return selection_ops.SelectionParams(**dict(fields))


def kernel_config(fields: Mapping[str, Any]) -> executor.KernelConfig:
    """KernelConfig from the JAX package's KernelConfig fields (plan
    entries and selection as mappings or dataclass-like objects, the
    noise and norm kinds as enums of either package or their values; secure
    and numeric_mode carry across as they are)."""
    fields = dict(fields)
    plan = tuple(
        executor.MetricPlanEntry(kind=e["kind"], outputs=tuple(e["outputs"]),
                                 n_stds=int(e["n_stds"]))
        for e in (_as_dict(entry) for entry in fields.pop("plan")))
    selection = fields.pop("selection")
    noise_kind = fields.pop("noise_kind")
    norm_kind = fields.pop("vector_norm_kind", None)
    return executor.KernelConfig(
        plan=plan,
        selection=(None if selection is None else
                   selection_params(_as_dict(selection))),
        noise_kind=NoiseKind(getattr(noise_kind, "value", noise_kind)),
        vector_norm_kind=(None if norm_kind is None else
                          NormKind(getattr(norm_kind, "value", norm_kind))),
        quantiles=tuple(fields.pop("quantiles", ())),
        **fields)


def noise_stds(stds) -> np.ndarray:
    """Noise stds in plan order, float64."""
    return np.asarray(stds, dtype=np.float64).reshape(-1)


def threefry_key(key) -> np.ndarray:
    """A raw threefry key (uint32[2])."""
    key = np.asarray(key, dtype=np.uint32).reshape(-1)
    if key.shape != (2,):
        raise ValueError(f"a threefry key has two uint32 words, got {key}")
    return key


def row_tensors(pid, pk, values, valid, device, dtype: torch.dtype):
    """Padded row arrays (numpy) as the kernels' tensors."""
    return (torch.as_tensor(np.asarray(pid, dtype=np.int32)).to(device),
            torch.as_tensor(np.asarray(pk, dtype=np.int32)).to(device),
            torch.as_tensor(np.asarray(values)).to(device=device,
                                                    dtype=dtype),
            torch.as_tensor(np.asarray(valid, dtype=bool)).to(device))


def pld(probs, lower_index: int, interval: float,
        infinity_mass: float) -> pldlib.PrivacyLossDistribution:
    """The port's PrivacyLossDistribution from a JAX one's fields (its
    `probs`, `_lower_index`, `interval` and `infinity_mass`)."""
    return pldlib.PrivacyLossDistribution(
        np.array(probs, dtype=np.float64), int(lower_index), float(interval),
        float(infinity_mass))


HISTOGRAM_FIELDS = ("l0_contributions_histogram", "l1_contributions_histogram",
                    "linf_contributions_histogram",
                    "linf_sum_contributions_histogram",
                    "count_per_partition_histogram",
                    "count_privacy_id_per_partition")


def histograms_fields(dataset_histograms) -> Tuple[Optional[tuple], ...]:
    """Either package's DatasetHistograms as plain tuples, one per
    histogram in field order: None, or (type value, ((lower, upper, count,
    sum, max), ...))."""
    out = []
    for field in HISTOGRAM_FIELDS:
        h = getattr(dataset_histograms, field)
        out.append(None if h is None else (h.name.value, tuple(
            (b.lower, b.upper, b.count, b.sum, b.max) for b in h.bins)))
    return tuple(out)


def _as_dict(obj) -> Dict[str, Any]:
    if isinstance(obj, Mapping):
        return dict(obj)
    return {k: getattr(obj, k) for k in obj.__dataclass_fields__}
