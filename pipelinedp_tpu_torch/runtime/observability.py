"""Observability: Prometheus text, memory watermarks, the budget odometer.

Port of the parts of pipelinedp_tpu/runtime/observability.py that the
multi-tenant service runs:

  * ``render_prometheus()`` serializes every declared counter and gauge
    (telemetry.REGISTRY) in Prometheus text, gauges labelled by job_id;
    ``parse_prometheus()`` is the strict line-grammar check.
  * ``memory_watermark()``: torch.cuda.memory_allocated /
    max_memory_allocated where CUDA is initialized ("device"), else the
    byte-accounted fallback (``account_bytes`` / ``release_bytes``,
    "accounted") as the JAX package keeps on the CPU.
  * The privacy-budget odometer: every
    ``BudgetAccountant._register_mechanism`` appends one ordered record
    (job, metric label, mechanism kind, weight, sensitivity; eps / delta
    read through the shared MechanismSpec once compute_budgets fills it).
    ``odometer_report`` reconciles the records with the accountant;
    ``persist_odometer`` / ``load_odometer`` write and read a trail
    through the BlockJournal in the JAX package's record layout.

The HTTP / file exporter (MetricsExporter), the span memory sampler, the
process-state export and the pod rollup are not ported yet (ROADMAP item
13).
"""

import contextlib
import dataclasses
import re
import threading
import weakref
from typing import Any, Dict, List, Optional

import numpy as np

from pipelinedp_tpu_torch.runtime.concurrency import guarded_by

PROM_PREFIX = "pdp_"

_PROM_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_PROM_HELP_RE = re.compile(rf"^# HELP ({_PROM_NAME}) (.*)$")
_PROM_TYPE_RE = re.compile(rf"^# TYPE ({_PROM_NAME}) (counter|gauge)$")
_PROM_SAMPLE_RE = re.compile(
    rf"^({_PROM_NAME})"
    r"(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\.)*\")"
    r"(?:,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\.)*\")*)\})?"
    r" (-?(?:[0-9]+(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?|\+?Inf|NaN))$")
_PROM_LABEL_RE = re.compile(
    r"([a-zA-Z_][a-zA-Z0-9_]*)=\"((?:[^\"\\\n]|\\.)*)\"")


def _prom_escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _prom_escape_label(text: str) -> str:
    return (text.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _prom_number(value: float) -> str:
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus() -> str:
    """The process's declared counters and gauges as Prometheus text: one
    HELP / TYPE pair per metric, counters unlabelled (0 when never
    recorded), gauges labelled job_id="..." where set under a job. The
    sampled gauges are refreshed first."""
    from pipelinedp_tpu_torch.runtime import telemetry

    refresh_gauges()
    counters = telemetry.snapshot()
    gauges = telemetry.gauge_snapshot()
    lines: List[str] = []
    for metric in telemetry.REGISTRY.values():
        name = PROM_PREFIX + metric.name
        lines.append(f"# HELP {name} {_prom_escape_help(metric.help)}")
        lines.append(f"# TYPE {name} {metric.kind}")
        if metric.kind == "counter":
            count = counters.get(metric.name, 0)
            lines.append(f"{name} {_prom_number(count)}")
            continue
        by_job = gauges.get(metric.name, {})
        for job in sorted(by_job):
            if job:
                lines.append(f'{name}{{job_id="{_prom_escape_label(job)}"}} '
                             f"{_prom_number(by_job[job])}")
            else:
                lines.append(f"{name} {_prom_number(by_job[job])}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, Dict[str, Any]]:
    """Strictly parses Prometheus text: every line is a HELP, a TYPE
    counter|gauge, a sample after its TYPE, or blank; anything else
    raises ValueError naming the line. Returns {metric: {"type", "help",
    "samples": {label_string or "": value}}}."""
    out: Dict[str, Dict[str, Any]] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        m = _PROM_HELP_RE.match(line)
        if m:
            out.setdefault(m.group(1), {"samples": {}})["help"] = m.group(2)
            continue
        m = _PROM_TYPE_RE.match(line)
        if m:
            out.setdefault(m.group(1), {"samples": {}})["type"] = m.group(2)
            continue
        m = _PROM_SAMPLE_RE.match(line)
        if m:
            name, labels, number = m.group(1), m.group(2), m.group(3)
            if name not in out or "type" not in out[name]:
                raise ValueError(
                    f"prometheus line {lineno}: sample for {name!r} "
                    f"before its # TYPE declaration")
            label_key = (",".join(f"{k}={v}" for k, v in
                                  _PROM_LABEL_RE.findall(labels))
                         if labels else "")
            out[name]["samples"][label_key] = float(number)
            continue
        raise ValueError(
            f"prometheus line {lineno} fails the grammar: {line!r}")
    for name, entry in out.items():
        if "type" not in entry:
            raise ValueError(f"metric {name!r} has HELP but no TYPE line")
    return out


# ---------------------------------------------------------------------------
# Device-memory watermarks

_mem_lock = threading.Lock()
_acct_live_bytes = 0
_acct_peak_bytes = 0
_GUARDED_BY = guarded_by("_mem_lock", "_acct_live_bytes",
                         "_acct_peak_bytes")


def account_bytes(n: int) -> None:
    """Adds n bytes to the byte-accounted live set (the CPU fallback)."""
    global _acct_live_bytes, _acct_peak_bytes
    with _mem_lock:
        _acct_live_bytes += int(n)
        _acct_peak_bytes = max(_acct_peak_bytes, _acct_live_bytes)


def release_bytes(n: int) -> None:
    global _acct_live_bytes
    with _mem_lock:
        _acct_live_bytes = max(_acct_live_bytes - int(n), 0)


def _device_memory_stats() -> Optional[Dict[str, int]]:
    """Live and peak bytes allocated on the card by torch's caching
    allocator; None where CUDA is absent or not initialized (never
    initializes it)."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return {"live_bytes": int(torch.cuda.memory_allocated()),
            "peak_bytes": int(torch.cuda.max_memory_allocated())}


def memory_watermark() -> Dict[str, Any]:
    """{"live_bytes", "peak_bytes", "source"}: the card's allocator stats
    ("device"), else the byte-accounted fallback ("accounted")."""
    stats = _device_memory_stats()
    if stats is not None:
        return {**stats, "source": "device"}
    with _mem_lock:
        return {"live_bytes": _acct_live_bytes,
                "peak_bytes": _acct_peak_bytes, "source": "accounted"}


# ---------------------------------------------------------------------------
# Privacy-budget odometer

ODOMETER_KEY = "__odometer__"

_odo_lock = threading.Lock()
_odo_records: List["OdometerRecord"] = []
_odo_seq = 0
_GUARDED_BY = guarded_by("_odo_lock", "_odo_records", "_odo_seq")

_odo_local = threading.local()


@dataclasses.dataclass
class OdometerRecord:
    """One mechanism registration, in ledger order. eps / delta / noise_std
    read through the shared MechanismSpec, so a record made at graph build
    reports the final share once the budget is computed (None before)."""
    seq: int
    job_id: Optional[str]
    metric: Optional[str]
    mechanism_kind: str
    weight: float
    sensitivity: float
    count: int
    process_index: int
    _spec: Any = dataclasses.field(repr=False)
    _accountant_ref: Any = dataclasses.field(repr=False)

    @property
    def eps(self) -> Optional[float]:
        return getattr(self._spec, "_eps", None)

    @property
    def delta(self) -> Optional[float]:
        return getattr(self._spec, "_delta", None)

    @property
    def noise_std(self) -> Optional[float]:
        return getattr(self._spec, "_noise_standard_deviation", None)

    def accountant(self):
        return self._accountant_ref()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "seq": self.seq,
            "job_id": self.job_id,
            "metric": self.metric,
            "mechanism_kind": self.mechanism_kind,
            "weight": self.weight,
            "sensitivity": self.sensitivity,
            "count": self.count,
            "process_index": self.process_index,
            "eps": self.eps,
            "delta": self.delta,
            "noise_std": self.noise_std,
        }


@contextlib.contextmanager
def mechanism_label(metric: str):
    """Labels the mechanism registrations inside the scope with the DP
    metric they serve."""
    prev = getattr(_odo_local, "label", None)
    _odo_local.label = metric
    try:
        yield
    finally:
        _odo_local.label = prev


def record_mechanism(accountant, mechanism) -> None:
    """BudgetAccountant._register_mechanism hook: appends one ordered
    record."""
    global _odo_seq
    from pipelinedp_tpu_torch.runtime import health

    h = health.current()
    spec = getattr(mechanism, "mechanism_spec", None)
    record = OdometerRecord(
        seq=0,
        job_id=h.job_id if h is not None else None,
        metric=getattr(_odo_local, "label", None),
        mechanism_kind=str(getattr(spec, "mechanism_type", "")),
        weight=float(getattr(mechanism, "weight", 1.0)),
        sensitivity=float(getattr(mechanism, "sensitivity", 1.0)),
        count=int(getattr(spec, "_count", 1) or 1),
        process_index=health._process_index(),
        _spec=spec,
        _accountant_ref=weakref.ref(accountant),
    )
    with _odo_lock:
        record.seq = _odo_seq
        _odo_seq += 1
        _odo_records.append(record)


def _records_snapshot() -> List[OdometerRecord]:
    with _odo_lock:
        return list(_odo_records)


def prune_odometer(accountant=None, job_id: Optional[str] = None) -> int:
    """Removes one accountant's and/or one job's records from the
    in-memory trail; returns how many went. At least one filter is
    required (an unfiltered wipe is telemetry.reset()'s)."""
    if accountant is None and job_id is None:
        raise ValueError(
            "prune_odometer: pass accountant= and/or job_id= - an "
            "unfiltered prune of the full trail is telemetry.reset()'s.")
    with _odo_lock:
        kept = []
        removed = 0
        for record in _odo_records:
            if ((accountant is None or record.accountant() is accountant)
                    and (job_id is None or record.job_id == job_id)):
                removed += 1
            else:
                kept.append(record)
        _odo_records[:] = kept
    return removed


def odometer_report(accountant=None,
                    job_id: Optional[str] = None) -> Dict[str, Any]:
    """Spent-vs-remaining over the ordered trail, filtered to one
    accountant and/or one job: ``records``, ``mechanisms``,
    ``spent_epsilon`` / ``spent_delta`` (computed shares times their
    counts, folded left to right in record order), ``pending``; with an
    accountant also ``total_epsilon``, ``remaining_epsilon``,
    ``ledger_spent_epsilon`` and ``reconciled`` (the record count equals
    mechanism_count and the eps fold equals spent_epsilon() exactly)."""
    records = _records_snapshot()
    if accountant is not None:
        records = [r for r in records if r.accountant() is accountant]
    if job_id is not None:
        records = [r for r in records if r.job_id == job_id]
    spent_eps = 0.0
    spent_delta = 0.0
    pending = 0
    for r in records:
        if r.eps is None:
            pending += 1
        else:
            spent_eps += r.eps * r.count
            if r.delta:
                spent_delta += r.delta * r.count
    report: Dict[str, Any] = {
        "records": [r.to_dict() for r in records],
        "mechanisms": len(records),
        "spent_epsilon": spent_eps,
        "spent_delta": spent_delta,
        "pending": pending,
    }
    if accountant is not None:
        total = float(getattr(accountant, "_total_epsilon", 0.0))
        ledger_spent = accountant.spent_epsilon()
        report["total_epsilon"] = total
        report["remaining_epsilon"] = max(total - spent_eps, 0.0)
        report["ledger_spent_epsilon"] = ledger_spent
        report["reconciled"] = (len(records) == accountant.mechanism_count
                                and ledger_spent == spent_eps)
    return report


def persist_odometer(journal, job_id: str,
                     records: Optional[List[Dict[str, Any]]] = None) -> None:
    """Writes an ordered trail through the BlockJournal (key
    ``__odometer__``) in the JAX package's record layout: ids = seq, and
    the columns eps / delta / noise_std (NaN for None), weight,
    sensitivity, count, process_index, job_id, metric, mechanism_kind.
    Default: the process's whole in-memory trail; ``records`` persists an
    explicit one (a tenant's ledger)."""
    from pipelinedp_tpu_torch.runtime.journal import BlockRecord

    rows = (records if records is not None else
            [r.to_dict() for r in _records_snapshot()])

    def _col(key, none_value=None):
        return [none_value if r.get(key) is None else r[key] for r in rows]

    record = BlockRecord(
        ids=np.asarray(_col("seq"), dtype=np.int64),
        outputs={
            "eps": np.asarray(_col("eps", np.nan), dtype=np.float64),
            "delta": np.asarray(_col("delta", np.nan), dtype=np.float64),
            "noise_std": np.asarray(_col("noise_std", np.nan),
                                    dtype=np.float64),
            "weight": np.asarray(_col("weight"), np.float64),
            "sensitivity": np.asarray(_col("sensitivity"), np.float64),
            "count": np.asarray(_col("count"), np.int64),
            "process_index": np.asarray(_col("process_index"), np.int32),
            "job_id": np.asarray(_col("job_id", ""), dtype=np.str_),
            "metric": np.asarray(_col("metric", ""), dtype=np.str_),
            "mechanism_kind": np.asarray(_col("mechanism_kind", ""),
                                         dtype=np.str_),
        } if rows else {})
    journal.put(job_id, ODOMETER_KEY, record)


def load_odometer(journal, job_id: str) -> List[Dict[str, Any]]:
    """Reads a persisted trail back (ordered dicts; [] when none). A
    corrupt record quarantines."""
    record = journal.get(job_id, ODOMETER_KEY)
    if record is None or record.ids.size == 0:
        return []
    out = []
    for i, seq in enumerate(record.ids):
        eps = float(record.outputs["eps"][i])
        delta = float(record.outputs["delta"][i])
        noise_std = (float(record.outputs["noise_std"][i])
                     if "noise_std" in record.outputs else np.nan)
        out.append({
            "seq": int(seq),
            "job_id": str(record.outputs["job_id"][i]) or None,
            "metric": str(record.outputs["metric"][i]) or None,
            "mechanism_kind": str(record.outputs["mechanism_kind"][i]),
            "weight": float(record.outputs["weight"][i]),
            "sensitivity": float(record.outputs["sensitivity"][i]),
            "count": int(record.outputs["count"][i]),
            "process_index": int(record.outputs["process_index"][i]),
            "eps": None if np.isnan(eps) else eps,
            "delta": None if np.isnan(delta) else delta,
            "noise_std": None if np.isnan(noise_std) else noise_std,
        })
    return out


def refresh_gauges() -> None:
    """Re-samples the queryable gauges: the memory watermark, each job's
    health state and each live accountant's remaining budget."""
    from pipelinedp_tpu_torch.runtime import health
    from pipelinedp_tpu_torch.runtime import telemetry

    wm = memory_watermark()
    telemetry.set_gauge("device_memory_live_bytes", wm["live_bytes"],
                        job_id=None)
    telemetry.set_gauge("device_memory_peak_bytes", wm["peak_bytes"],
                        job_id=None)
    for job, snap in health.snapshot_all().items():
        telemetry.set_gauge("job_health_state",
                            health.HealthState[snap["state"]].value,
                            job_id=job)
    seen = set()
    for r in _records_snapshot():
        acc = r.accountant()
        if acc is None or id(acc) in seen:
            continue
        seen.add(id(acc))
        report = odometer_report(accountant=acc)
        telemetry.set_gauge("budget_epsilon_remaining",
                            report["remaining_epsilon"], job_id=r.job_id)


def reset_epoch() -> None:
    """Clears the odometer and the byte accounting (telemetry.reset())."""
    global _acct_live_bytes, _acct_peak_bytes, _odo_seq
    with _mem_lock:
        _acct_live_bytes = 0
        _acct_peak_bytes = 0
    with _odo_lock:
        _odo_records.clear()
        _odo_seq = 0
