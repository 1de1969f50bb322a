"""The port's plan lint (``python -m repro_torch.lint``) on the CPU pack.

Every target — a plan the port itself constructs: the §3.1 inner product's
runner, two-level Cannon, the packed decode plan, the engine's and the
training loop's plans, the matmul at every variant's tile, flash, the dot,
the scan and its backward, and the dry-run report's hot spots — builds and
verifies clean against the calibrated CPU pack. A corrupted plan (an
aliased up-stream, a seek past the end of its stream) is an error, and
``--check`` exits 1 on it.
"""

import numpy as np
import pytest

from repro_torch import lint
from repro_torch.core.calibrate import default_machine
from repro_torch.core.hyperstep import HyperstepRunner
from repro_torch.core.stream import StreamSet
from repro_torch.core.verify import verify_runner

NAMES = [name for name, _ in lint._TARGETS]


def test_the_targets_are_the_ports_plans():
    assert NAMES == [
        "core/hyperstep:inner_product", "distributed/cannon:two_level",
        "distributed/cannon:two_level_mesh", "examples/bsps_spmv:ell_blocks",
        "core/plan:packed_decode", "launch/engine:packed_decode", "train/loop:host_plan",
        "kernels/streamed_matmul:variants", "kernels/flash_attention:gqa",
        "kernels/streamed_dot:inner_product", "kernels/ssm_scan:chunked",
        "kernels/ssm_scan:backward", "launch/dryrun:stream_plans"]


@pytest.mark.parametrize("name", NAMES)
def test_target_builds_and_verifies_clean_on_the_cpu_pack(name):
    fn = dict(lint._TARGETS)[name]
    diags = fn(default_machine(device="cpu"), "cpu")
    assert not [d.format() for d in diags if d.severity == "error"]


def test_check_passes_on_the_port(capsys):
    assert lint.main(["--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"{len(NAMES)} plan targets on cpu-host" in out
    assert "all plans verify clean" in out and "BUILD-FAIL" not in out


def _aliased_upstream(machine, device):
    s = StreamSet().create(np.zeros(16, np.float32), 4, name="shared")
    runner = HyperstepRunner(lambda a, t: a, [s], out_streams=[s], out_every=[1],
                             machine=machine, device=device)
    return verify_runner(runner, num_hypersteps=2)


def _seek_past_the_end(machine, device):
    s = StreamSet().create(np.zeros(16, np.float32), 4, name="v")
    runner = HyperstepRunner(lambda a, t: a, [s], machine=machine, device=device,
                             on_hyperstep_end=lambda h, ss: ss[0].seek(0, 3))
    return verify_runner(runner)


@pytest.mark.parametrize("bad, code, errors", [(_aliased_upstream, "BSPS142", 1),
                                               (_seek_past_the_end, "BSPS101", 2)],
                         ids=["aliased_upstream", "seek_past_end"])
def test_a_corrupted_plan_is_an_error_and_check_exits_1(bad, code, errors, monkeypatch,
                                                         capsys):
    monkeypatch.setattr(lint, "_TARGETS", lint._TARGETS + [("corrupted", bad)])
    assert lint.main(["--check", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAIL        corrupted" in out and f"{code} error" in out
    # the seek past the end also leaves the walk a token short (BSPS102)
    assert f"{errors} error finding(s), 0 target build failure(s)" in out
    # without --check the table is printed and the exit code is 0
    assert lint.run_lint(check=False, device="cpu") == 0


def test_a_target_that_fails_to_build_fails_the_check(monkeypatch, capsys):
    def broken(machine, device):
        raise RuntimeError("plan constructor regression")

    monkeypatch.setattr(lint, "_TARGETS", lint._TARGETS + [("broken", broken)])
    assert lint.run_lint(check=True, device="cpu") == 1
    assert "BUILD-FAIL  broken" in capsys.readouterr().out
