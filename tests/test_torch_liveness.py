"""Mesh liveness of the port: slot identity, the process topology of a
mesh, probe_live_devices and join_candidates
(pipelinedp_tpu_torch/parallel/mesh.py), and K23c collective_heartbeat
on C21's int32 entry (kernels.heartbeat_sum; here its plain version,
combine_shards_plain), against the JAX package's (tests/test_multihost.py
TestMeshHelpers and TestRemoteLiveness, with its FakeDevice; parallel/
mesh.py:150 collective_heartbeat over D host devices).

A port mesh's slots may name another process (Slot(id, device,
process_index)); this process still drives them, and the elastic loop
learns their liveness from the fault schedule or the heartbeat, as the
JAX package learns a remote device's. Bounds: every result here is a set
of ids or a count, equal to the JAX package's.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from pipelinedp_tpu.parallel import make_mesh as jax_make_mesh
from pipelinedp_tpu.parallel import mesh as jax_mesh_lib
from pipelinedp_tpu.runtime import faults as jax_faults
from pipelinedp_tpu_torch import kernels
from pipelinedp_tpu_torch.parallel import mesh as mesh_lib
from pipelinedp_tpu_torch.parallel.mesh import Slot, make_mesh
from pipelinedp_tpu_torch.runtime import faults
from pipelinedp_tpu_torch.runtime import retry
from pipelinedp_tpu_torch.runtime import telemetry

from test_torch_elastic import FAST, _blocked_agg, _key, assert_same

pytestmark = pytest.mark.torch_port


class FakeDevice:
    """tests/test_multihost.py's stand-in for a remote device: an id and
    an owning process."""

    def __init__(self, id_, process_index):
        self.id = id_
        self.process_index = process_index

    def __repr__(self):
        return f"FakeDevice(id={self.id}, p={self.process_index})"


@pytest.fixture(autouse=True)
def _no_tickets():
    retry.clear_joins()
    yield
    retry.clear_joins()


def cpu_slots(processes):
    """One CPU slot a process index, ids 0.. in order."""
    return [Slot(i, "cpu", p) for i, p in enumerate(processes)]


class TestSlots:

    def test_ids_are_kept_and_part_of_equality(self):
        mesh = make_mesh(["cpu"] * 4)
        assert mesh.ids == (0, 1, 2, 3)
        assert mesh.devices == (torch.device("cpu"),) * 4
        survivors = make_mesh(devices=[mesh.slots[0], mesh.slots[2],
                                       mesh.slots[3]])
        assert survivors.ids == (0, 2, 3)
        assert survivors != make_mesh(["cpu"] * 3)
        assert survivors == make_mesh(devices=list(survivors.slots))
        assert hash(survivors) == hash(make_mesh(
            devices=list(survivors.slots)))
        assert make_mesh([Slot(5, "cpu"), "cpu", "cpu"]).ids == (5, 0, 1)
        assert make_mesh(["cpu"] * 8, n_devices=2).ids == (0, 1)
        with pytest.raises(ValueError, match="distinct"):
            make_mesh([Slot(1, "cpu"), Slot(1, "cpu")])
        assert Slot(2, "cpu", 1) != Slot(2, "cpu")
        assert repr(Slot(2, "cpu", 1)) == "Slot(2, cpu, process 1)"

    def test_single_process_topology_matches_jax(self):
        port, ref = make_mesh(["cpu"] * 4), jax_make_mesh(n_devices=4)
        for lib, mesh in ((mesh_lib, port), (jax_mesh_lib, ref)):
            assert lib.process_index() == 0 and lib.process_count() == 1
            assert lib.is_fully_addressable(mesh)
            assert lib.mesh_processes(mesh) == [0]
            assert lib.cross_process_fraction(mesh) == 0.0
        assert mesh_lib.local_devices(port) == list(port.devices)
        assert [s.id for s in port.slots] == [d.id for d in
                                              ref.devices.flat]

    def test_cross_process_fraction_counts_pairs_as_jax(self):
        port = make_mesh(devices=cpu_slots([0, 0, 1, 1]))

        class M:
            devices = np.asarray([FakeDevice(i, i // 2) for i in range(4)],
                                 dtype=object)

        assert mesh_lib.cross_process_fraction(port) == pytest.approx(8 / 12)
        assert mesh_lib.cross_process_fraction(port) == \
            jax_mesh_lib.cross_process_fraction(M())
        assert mesh_lib.mesh_processes(port) == \
            jax_mesh_lib.mesh_processes(M()) == [0, 1]
        assert not mesh_lib.is_fully_addressable(port)
        assert mesh_lib.local_devices(port) == [torch.device("cpu")] * 2
        assert mesh_lib.device_process(object()) == 0
        assert mesh_lib.device_process(torch.device("cpu")) == 0


class TestRemoteLiveness:
    """tests/test_multihost.py TestRemoteLiveness, each case run on both
    packages."""

    @staticmethod
    def both(devices, schedule=None, **kw):
        out = []
        for fmod, lib in ((faults, mesh_lib), (jax_faults, jax_mesh_lib)):
            if schedule is None:
                out.append(lib.probe_live_devices(devices, **kw))
                continue
            sched = fmod.FaultSchedule([fmod.Fault(**schedule)])
            sched.note_device_loss(sched._remaining[0][0])
            with fmod.inject(sched):
                out.append(lib.probe_live_devices(devices, **kw))
        assert [d.id for d in out[0]] == [d.id for d in out[1]]
        return out[0]

    def test_schedule_is_the_remote_oracle(self):
        remote = [FakeDevice(100, 1), FakeDevice(101, 1), FakeDevice(102, 2)]
        live = self.both(remote, dict(kind="device_loss", process=1))
        assert [d.id for d in live] == [102]

    def test_heartbeat_decides_without_schedule(self):
        remote = [FakeDevice(100, 1), FakeDevice(101, 1)]
        assert self.both(remote, heartbeat=lambda devs: set(devs)) == remote

        def broken(devs):
            raise RuntimeError("DCN unreachable")

        assert self.both(remote, heartbeat=broken) == []

    def test_heartbeat_partial_answer(self):
        remote = [FakeDevice(100, 1), FakeDevice(101, 2)]
        live = self.both(remote, heartbeat=lambda devs: {devs[0]})
        assert [d.id for d in live] == [100]

    def test_local_slots_still_round_trip(self):
        slots = list(make_mesh(["cpu"] * 2).slots)
        assert mesh_lib.probe_live_devices(slots) == slots
        assert jax_mesh_lib.probe_live_devices(jax.devices()[:2]) == \
            list(jax.devices()[:2])

    def test_a_local_slot_failing_its_round_trip_is_lost(self, caplog):
        slots = list(make_mesh(["cpu"] * 3).slots)
        real = mesh_lib.host_fetch
        calls = []

        def fetch(t, max_retries=None):
            calls.append(max_retries)
            if len(calls) == 2:
                raise RuntimeError("device is lost")
            return real(t, max_retries)

        with pytest.MonkeyPatch.context() as mp, \
                caplog.at_level(logging.WARNING):
            mp.setattr(mesh_lib, "host_fetch", fetch)
            live = mesh_lib.probe_live_devices(slots)
        assert [s.id for s in live] == [0, 2]
        assert calls == [0, 0, 0]
        assert any("failed its probe round trip" in r.getMessage()
                   for r in caplog.records)

    def test_assign_lost_covers_whole_process(self):
        for fmod in (faults, jax_faults):
            devs = [FakeDevice(i, i // 2) for i in range(6)]
            sched = fmod.FaultSchedule(
                [fmod.Fault("device_loss", process=2)])
            sched.note_device_loss(sched._remaining[0][0])
            assert sched.assign_lost(devs) == {4, 5}
        slots = cpu_slots([0, 0, 1, 1, 2, 2])
        sched = faults.FaultSchedule([faults.Fault("device_loss",
                                                   process=2)])
        sched.note_device_loss(sched._remaining[0][0])
        assert sched.assign_lost(slots) == {4, 5}


class TestHeartbeat:

    @pytest.mark.parametrize("d", [1, 4, 8])
    def test_plain_heartbeat_matches_jax(self, d):
        port = mesh_lib.collective_heartbeat(["cpu"] * d)
        ref = jax_mesh_lib.collective_heartbeat(jax.devices()[:d])
        assert {s.id for s in port} == {dev.id for dev in ref}
        assert len(port) == d

    def test_heartbeat_sum_plain_version(self):
        stack = torch.ones(5, 1, dtype=torch.int32)
        before = dict(kernels.launch_counts)
        out = kernels.heartbeat_sum(stack)
        assert out.dtype == torch.int32 and out.tolist() == [5]
        assert torch.equal(out, kernels.combine_shards_plain(stack))
        assert dict(kernels.launch_counts) == before  # the CPU's path
        for bad in (torch.ones(3, 2, dtype=torch.int32),
                    torch.ones(3, 1, dtype=torch.int64),
                    torch.ones(65, 1, dtype=torch.int32),
                    torch.ones(3, dtype=torch.int32)):
            with pytest.raises(ValueError, match="heartbeat_sum"):
                kernels.heartbeat_sum(bad)

    def test_a_wrong_sum_raises(self):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kernels, "heartbeat_sum",
                       lambda stack: torch.tensor([stack.shape[0] - 1],
                                                  dtype=torch.int32))
            with pytest.raises(RuntimeError, match="returned 3, expected 4"):
                mesh_lib.collective_heartbeat(["cpu"] * 4)

    def test_remote_slots_go_through_the_heartbeat(self, caplog):
        """No schedule and no override: a slot of another process is
        proven by collective_heartbeat (the route that launches C21 on
        the card); if the heartbeat fails, the remote slots are lost and
        the failure is logged, and the local ones still round-trip."""
        slots = cpu_slots([0, 0, 1, 1])
        seen = []
        real = mesh_lib.collective_heartbeat

        def spy(devices):
            seen.append([d.id for d in devices])
            return real(devices)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mesh_lib, "collective_heartbeat", spy)
            assert mesh_lib.probe_live_devices(slots) == slots
        assert seen == [[0, 1, 2, 3]]

        def fail(stack):
            raise RuntimeError("CUDA error: unspecified launch failure")

        with pytest.MonkeyPatch.context() as mp, \
                caplog.at_level(logging.WARNING):
            mp.setattr(kernels, "heartbeat_sum", fail)
            live = mesh_lib.probe_live_devices(slots)
        assert [s.id for s in live] == [0, 1]
        assert any("collective heartbeat over 4 devices failed" in
                   r.getMessage() for r in caplog.records)


class TestJoinCandidates:

    def test_target_total_fills_new_ids_as_jax(self):
        port = mesh_lib.join_candidates(make_mesh(["cpu"] * 4), n_devices=8)
        ref = jax_mesh_lib.join_candidates(jax_make_mesh(n_devices=4),
                                           n_devices=8)
        assert [s.id for s in port] == [d.id for d in ref] == [4, 5, 6, 7]
        assert all(s.device == torch.device("cpu") for s in port)
        shrunk = make_mesh(devices=[Slot(0, "cpu"), Slot(2, "cpu")])
        assert [s.id for s in mesh_lib.join_candidates(
            shrunk, n_devices=4)] == [1, 3]
        assert mesh_lib.join_candidates(shrunk, n_devices=2) == []
        assert mesh_lib.join_candidates(shrunk) == []

    def test_explicit_slots_drop_current_ids_as_jax(self):
        mesh = make_mesh(["cpu"] * 2)
        joining = [Slot(1, "cpu"), Slot(7, "cpu", 1)]
        port = mesh_lib.join_candidates(mesh, devices=joining)
        ref = jax_mesh_lib.join_candidates(jax_make_mesh(n_devices=2),
                                           devices=[1, 7])
        assert [s.id for s in port] == ref == [7]

    def test_cuda_enumeration_without_cuda_is_empty(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        mesh = make_mesh(["cpu"])
        # A one-slot CPU mesh still grows on the CPU.
        assert [s.id for s in mesh_lib.join_candidates(
            mesh, n_devices=3)] == [1, 2]


class TestWholeHost:

    def test_a_lost_process_is_a_host_loss(self):
        mesh = make_mesh(devices=cpu_slots([0, 0, 1, 1]))
        base = _blocked_agg(make_mesh(["cpu"] * 4), _key(81))
        sched = faults.FaultSchedule(
            [faults.Fault("device_loss", point="dispatch", process=1)])
        before = telemetry.snapshot()
        with faults.inject(sched):
            got = _blocked_agg(mesh, _key(81), retry=FAST, elastic=True,
                               job_id="t-host-loss")
        assert_same(got, base)
        delta = telemetry.delta(before)
        assert delta.get("host_losses") == 1
        assert delta.get("mesh_degradations") == 1

    def test_this_process_evacuated(self):
        mesh = make_mesh(devices=cpu_slots([1, 1, 0, 0]))
        sched = faults.FaultSchedule(
            [faults.Fault("device_loss", point="dispatch", process=0)])
        with faults.inject(sched):
            with pytest.raises(retry.HostEvacuatedError,
                               match="evacuated this process"):
                _blocked_agg(mesh, _key(83), retry=FAST, elastic=True,
                             job_id="t-evacuated")

    def test_grow_onto_remote_slots_probes_by_heartbeat(self):
        """A join of slots that name process 1, with no fault schedule:
        the admit's probe runs collective_heartbeat, and the grown run
        releases the fixed run."""
        base = _blocked_agg(make_mesh(["cpu"] * 2), _key(85))
        seen = []
        real = mesh_lib.collective_heartbeat

        def spy(devices):
            seen.append([d.id for d in devices])
            return real(devices)

        retry.announce_join(devices=[Slot(2, "cpu", 1), Slot(3, "cpu", 1)],
                            block=2)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mesh_lib, "collective_heartbeat", spy)
            got = _blocked_agg(make_mesh(["cpu"] * 2), _key(85), retry=FAST,
                               elastic_grow=True, job_id="t-grow-remote")
        assert seen == [[0, 1, 2, 3]]
        assert_same(got, base)


def test_probe_spends_no_launch_on_the_cpu():
    """The probes and the heartbeat take the plain versions on CPU
    tensors: no wrapper counts a launch."""
    kernels.reset_launch_counts()
    mesh_lib.probe_live_devices(cpu_slots([0, 1]))
    assert all(v == 0 for v in kernels.launch_counts.values())
