"""pipelinedp_tpu_torch: the PyTorch / CUDA port of pipelinedp_tpu.

The port grows slice by slice beside the JAX package, which stays the
reference. It runs DPEngine.aggregate on the dense columnar route (COUNT,
PRIVACY_ID_COUNT, SUM, MEAN, VARIANCE, PERCENTILE and VECTOR_SUM with
Laplace or Gaussian noise, public partitions or private partition
selection, per-partition or total contribution bounds) and
DPEngine.select_partitions, and above large_partition_threshold both on the
blocked route (parallel/large_p.py), on one device or over a device mesh
(TorchBackend(mesh=, reshard=); parallel/), on
twenty-three CUDA kernels built for sm_90a at first use (kernels.py,
csrc/). Both take rows, a pre-encoded
columnar.EncodedData or a ChunkSource of column chunks, streamed to the
device (ingest.py, runtime/pipeline.py). PLD accounting
(PLDBudgetAccountant, accounting/), the dataset histograms
(dataset_histograms/) and utility analysis with parameter tuning
(analysis/, on the generic LocalBackend vocabulary that TorchBackend
inherits) complete it. The package imports torch, numpy and scipy, never
jax.
"""

from pipelinedp_tpu_torch.aggregate_params import (AggregateParams,
                                                   MechanismType, Metric,
                                                   Metrics, NoiseKind,
                                                   NormKind,
                                                   PartitionSelectionStrategy,
                                                   SelectPartitionsParams)
from pipelinedp_tpu_torch.budget_accounting import (BudgetAccountant,
                                                    NaiveBudgetAccountant,
                                                    PLDBudgetAccountant)
from pipelinedp_tpu_torch.data_extractors import (DataExtractors,
                                                  PreAggregateExtractors)
from pipelinedp_tpu_torch.device_encode import HashCollisionError
from pipelinedp_tpu_torch.dp_engine import DPEngine
from pipelinedp_tpu_torch.pipeline_backend import LocalBackend, TorchBackend
from pipelinedp_tpu_torch.report_generator import ExplainComputationReport
from pipelinedp_tpu_torch.runtime.pipeline import ChunkSource

__all__ = [
    "AggregateParams", "BudgetAccountant", "ChunkSource", "DataExtractors",
    "DPEngine", "ExplainComputationReport", "HashCollisionError",
    "LocalBackend", "MechanismType", "Metric", "Metrics",
    "NaiveBudgetAccountant", "NoiseKind", "NormKind",
    "PartitionSelectionStrategy", "PLDBudgetAccountant",
    "PreAggregateExtractors",
    "SelectPartitionsParams", "TorchBackend"
]
