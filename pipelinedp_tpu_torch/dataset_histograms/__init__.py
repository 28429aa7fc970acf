"""Dataset histograms: contribution-distribution statistics for tuning.

Port of pipelinedp_tpu/dataset_histograms/: the histogram types and
queries, the host columnar path, the error estimator, and
``device_histograms``, which computes all six histograms on the card (C5
sorts, C17 group_stats, C18 log_bins).
"""

from pipelinedp_tpu_torch.dataset_histograms import histograms
from pipelinedp_tpu_torch.dataset_histograms import computing_histograms
from pipelinedp_tpu_torch.dataset_histograms import device_histograms
from pipelinedp_tpu_torch.dataset_histograms import histogram_error_estimator
