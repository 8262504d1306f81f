"""A sticky device error, pinned on the CPU with an injected one.

On the card a device-side assert leaves the CUDA context unusable: every
later call raises. The Solver tells that apart from a device error that a
retry clears: a real device error that outlives its retry, after which a
one-element probe of the device (an op and a synchronize) fails too,
raises ``errors.DeviceLostError``, is kept in ``Solver.device_lost``, and
every later entry point raises it at once, without touching the device.
The CLI ends the run after that pass with ``EXIT_DEVICE_LOST`` (75), so
that the deployment restarts the process with a fresh context instead of
failing every later pass with solve-error; the solver sidecar process
stops serving and returns the same code.

Here the card is played by the CPU Solver with the card's ladder
(``_host_ffd_carries_all = False``, as on CUDA), a pack that raises the
error a device-side assert raises, and a probe that fails while the
"context" is lost. ``chip_smoke.py`` checks the same on the card with a
real device-side assert in a child process.

Tolerance: none.
"""

import threading

import pytest

import test_torch_cases as cases
from karpenter_provider_aws_tpu_torch import cli
from karpenter_provider_aws_tpu_torch.errors import (DeviceLostError,
                                                     SolverDeviceError)
from karpenter_provider_aws_tpu_torch.ops import binpack
from karpenter_provider_aws_tpu_torch.solver import Solver
from karpenter_provider_aws_tpu_torch.utils.clock import FakeClock
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

ASSERT = "CUDA error: device-side assert triggered"


class _Card:
    """A device that fails every pack once ``broken``, and whose probe
    fails too while ``sticky``."""

    def __init__(self, monkeypatch, sticky=True):
        self.broken = False
        self.sticky = sticky
        self.packs = 0
        real = binpack.pack_packed_efused

        def pack(*args, **kwargs):
            self.packs += 1
            if self.broken:
                raise RuntimeError(ASSERT)
            return real(*args, **kwargs)

        monkeypatch.setattr(binpack, "pack_packed_efused", pack)
        alive = Solver._device_alive
        monkeypatch.setattr(Solver, "_device_alive", lambda s: (
            not (self.broken and self.sticky)) and alive(s))


def _card_solver():
    s = Solver(cases.small_lattice(cases.TORCH_PKG), device="cpu",
               clock=FakeClock())
    s._host_ffd_carries_all = False          # the ladder of a CUDA Solver
    return s


def test_sticky_error_loses_the_device_and_every_later_call_fails_fast(
        monkeypatch):
    card = _Card(monkeypatch)
    s = _card_solver()
    lat, pods, pools, kw = cases.build(cases.TORCH_PKG, "generic")
    P = cases.mod(cases.TORCH_PKG, "solver.problem")
    problem = P.build_problem(pods, pools, lat)
    assert s.solve(problem).solver_path != "host-ffd"
    card.broken = True
    packs = card.packs
    with pytest.raises(DeviceLostError, match="restart") as err:
        s.solve_relaxed(pods, pools)
    assert isinstance(err.value, SolverDeviceError)
    assert not err.value.retryable
    assert card.packs == packs + 2                  # the solve and its retry
    assert s.degraded_counts == {"device_retry": 1}
    assert s.device_lost is not None
    assert ASSERT in str(s.device_lost.cause)
    for call in (lambda: s.solve(problem),
                 lambda: s.solve_relaxed(pods, pools),
                 lambda: s.solve_delta(problem),
                 lambda: s.probe_batch([problem])):
        with pytest.raises(DeviceLostError):
            call()
    assert card.packs == packs + 2                  # none touched the device
    assert s.degraded_counts == {"device_retry": 1}


def test_error_whose_probe_passes_is_not_sticky(monkeypatch):
    """The same error with a device that still runs the probe: the solve
    raises as any real device error on the card does, and the Solver is
    not lost (the next solve runs once the device works)."""
    card = _Card(monkeypatch, sticky=False)
    s = _card_solver()
    lat, pods, pools, kw = cases.build(cases.TORCH_PKG, "generic")
    card.broken = True
    with pytest.raises(SolverDeviceError) as err:
        s.solve_relaxed(pods, pools)
    assert not isinstance(err.value, DeviceLostError)
    assert s.device_lost is None
    card.broken = False
    assert not s.solve_relaxed(pods, pools).unschedulable


def _pending_operator(monkeypatch, built):
    """cli.Operator building an Operator on the small lattice with 40
    pending pods in its cluster."""
    A = cases.mod(cases.TORCH_PKG, "apis")
    real = cli.Operator

    def operator(*args, **kwargs):
        op = real(*args, lattice=cases.small_lattice(cases.TORCH_PKG),
                  **kwargs)
        op.solver._host_ffd_carries_all = False
        for i in range(40):
            op.cluster.add_pod(A.Pod(name=f"p{i}", requests={
                "cpu": "500m", "memory": "1Gi"}))
        built.append(op)
        return op

    monkeypatch.setattr(cli, "Operator", operator)


def test_cli_exits_after_the_pass_that_lost_the_device(monkeypatch):
    """The CLI's single-threaded loop: the first pass that solves hits the
    sticky error; that pass ends (its provisioner reports solve-error),
    and main returns EXIT_DEVICE_LOST without another pass, long before
    its 60 s duration."""
    card = _Card(monkeypatch)
    card.broken = True
    built = []
    _pending_operator(monkeypatch, built)
    passes = []
    from karpenter_provider_aws_tpu_torch.operator import Operator
    real_run = Operator.run_once

    def run(self, *a, **k):
        # whether this pass starts on a lost device
        passes.append(self.solver.device_lost is not None)
        return real_run(self, *a, **k)

    monkeypatch.setattr(Operator, "run_once", run)
    rc = cli.main(["--device", "cpu", "--metrics-port=0", "--duration=60",
                   "--step=0", "--batch-idle-duration=0",
                   "--batch-max-duration=0"])
    assert rc == cli.EXIT_DEVICE_LOST == 75
    op, = built
    assert passes and not any(passes)       # no pass after the loss
    assert op.solver.device_lost is not None
    assert [e.reason for e in op.recorder.events()].count("SolverFailed") == 1
    assert card.packs == 2


def test_async_runtime_exits_once_the_device_is_lost(monkeypatch):
    """The same with ``--async-runtime``: the controllers run on their own
    threads, and main returns EXIT_DEVICE_LOST once the provisioner's
    solve lost the device."""
    card = _Card(monkeypatch)
    card.broken = True
    built = []
    _pending_operator(monkeypatch, built)
    stop = threading.Event()
    timer = threading.Timer(60.0, stop.set)
    timer.start()
    try:
        rc = cli.main(["--device", "cpu", "--metrics-port=0",
                       "--async-runtime", "--batch-idle-duration=0",
                       "--batch-max-duration=0"], stop_event=stop)
    finally:
        timer.cancel()
    assert rc == cli.EXIT_DEVICE_LOST
    assert not stop.is_set()                   # it ended by itself
    assert built[0].solver.device_lost is not None


def test_sidecar_exits_once_the_device_is_lost(monkeypatch, tmp_path):
    """The solver sidecar process (``parallel/sidecar.py main``) serves
    until its Solver has lost the device, then stops serving and returns
    EXIT_DEVICE_LOST; its socket is gone."""
    from karpenter_provider_aws_tpu_torch.parallel import sidecar
    made = []

    class Tracked(Solver):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(sidecar, "Solver", Tracked)
    rc = []
    address = f"unix:{tmp_path}/s.sock"
    t = threading.Thread(target=lambda: rc.append(sidecar.main(
        ["--device", "cpu", "--synthetic-catalog", "--address", address])))
    t.start()
    try:
        for _ in range(600):
            if made and (tmp_path / "s.sock").exists():
                break
            t.join(0.1)
        assert made and (tmp_path / "s.sock").exists()
        client = sidecar.SolverClient(address)
        assert client.health()["types"] == made[0].lattice.T
        client.close()
        made[0].device_lost = DeviceLostError("a sticky error")
        t.join(30)
    finally:
        if t.is_alive():
            made[0].device_lost = DeviceLostError("stop")
            t.join(30)
    assert rc == [cli.EXIT_DEVICE_LOST]
    assert not (tmp_path / "s.sock").exists()
