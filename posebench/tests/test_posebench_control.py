"""``correct`` comes out false where it should: the controls (the
reference in the program's place one precision step down) and the
faults a cell can have, each planted under a run that skips the look
for a card and runs the rest on the CPU at a size a test can hold."""

import dataclasses
import os
import textwrap

import pytest
import torch

from conftest import REPO, small_copy
from posebench import calibrate
from posebench.lib import check, runner
from posebench.lib.cell import Cell
from tfpose_tpu_torch import estimator as est_mod

SEED = 2 ** 31 + 11
THIN = "configs/thin368coco-fp32-432x368.json"


def _thin_copy(tmp_path, workload, **change):
    edits = {f"workloads/{workload}.json": dict(
        scenes=8, check_images=4, **change)}
    return small_copy(tmp_path, edits)


def _control(root, workload, device):
    cell = Cell(workload, SEED, 1.0, False, device=str(device), root=root)
    cell.render()
    items = calibrate.control_items(cell, device)
    ids = [s for s, _, _ in items]
    ref = check.reference_maps(cell, ids, device)
    low = check.low_precision(cell)
    ref_low = None if low is None else check.reference_maps(
        cell, ids, device, dtype=low)
    return (check.compare(cell, items, ref, device, ref_low),
            cell.config["limits"])


def test_bf16_decode_control_fails(tmp_path):
    root = _thin_copy(tmp_path, "thin432-single")
    numbers, limits = _control(root, "thin432-single", torch.device("cpu"))
    assert numbers["humans_gap"] > limits["humans_gap"]


def test_int8_control_of_the_bf16_config_fails(tmp_path):
    root = small_copy(tmp_path, {
        "configs/cmu-bf16-656x368.json": {"input_wh": [96, 64]},
        "workloads/cmu656-bf16-batch16.json": dict(
            batch=2, scenes=4, check_images=4)})
    numbers, limits = _control(root, "cmu656-bf16-batch16",
                               torch.device("cpu"))
    assert numbers["maps_rms_ratio"] > limits["maps_rms_ratio"]


@pytest.mark.cuda
def test_tf32_control_fails_on_the_card(tmp_path, card):
    root = _thin_copy(tmp_path, "thin432-batch16")
    numbers, limits = _control(root, "thin432-batch16", card)
    assert numbers["maps_gap"] > limits["maps_gap"]


def _run(root, workload, seconds=3.0):
    result, _, _ = runner.run(workload, SEED, seconds, False, device="cpu",
                           root=root)
    return result


@pytest.mark.parametrize("workload", ["thin432-single", "thin432-batch16"])
def test_sound_runs_are_correct(tmp_path, workload):
    root = _thin_copy(tmp_path, workload, **(
        {"batch": 4} if workload == "thin432-batch16" else {}))
    assert _run(root, workload)["correct"]


def test_stale_answer_fails(tmp_path, monkeypatch):
    """A call that returns an earlier call's answer (its state unchanged):
    from the second call on, the second call's (a warm-up's, of another
    scene than the window's first), so that a window of one call shows it."""
    orig, first = est_mod.TfPoseEstimator.inference, []

    def stale(self, *args, **kw):
        out = orig(self, *args, **kw)
        first.append(out)
        return first[min(1, len(first) - 1)]

    monkeypatch.setattr(est_mod.TfPoseEstimator, "inference", stale)
    assert not _run(_thin_copy(tmp_path, "thin432-single"),
                    "thin432-single")["correct"]


def test_altered_answer_fails(tmp_path, monkeypatch):
    """A part moved by one pixel of the decode size where the humans
    are made."""
    orig = est_mod.TfPoseEstimator._humans

    def altered(arrays):
        humans = orig(arrays)
        if humans:
            parts = humans[0].body_parts
            p = next(iter(parts))
            parts[p] = dataclasses.replace(parts[p], x=parts[p].x + 1 / 216)
        return humans

    monkeypatch.setattr(est_mod.TfPoseEstimator, "_humans",
                        staticmethod(altered))
    assert not _run(_thin_copy(tmp_path, "thin432-single"),
                    "thin432-single")["correct"]


def test_half_the_batch_left_out_fails(tmp_path, monkeypatch):
    """The decode's answers kept for the first half of the batch only."""
    orig = est_mod.decode_batch

    def half(net_out, *args):
        out = orig(net_out, *args)
        valid = out.human_valid.clone()
        valid[net_out.shape[0] // 2:] = False
        return out._replace(human_valid=valid)

    monkeypatch.setattr(est_mod, "decode_batch", half)
    root = _thin_copy(tmp_path, "thin432-batch16", batch=4)
    assert not _run(root, "thin432-batch16")["correct"]


NO_EXCHANGE = textwrap.dedent('''
    import os
    if os.environ.get("POSEBENCH_TEST_FAULT") == "no_exchange":
        import torch
        import tfpose_tpu_torch.parallel.mesh as mesh

        def local_only(local, bounds, index, group, dim=0):
            if group is None:
                return local
            shape = list(local.shape)
            shape[dim] = bounds[-1]
            buf = torch.zeros(shape, dtype=local.dtype, device=local.device)
            buf.narrow(dim, bounds[index],
                       bounds[index + 1] - bounds[index]).copy_(local)
            return buf

        mesh.gather_blocks = local_only
''')


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_mesh_exchange_left_out_fails(tmp_path, monkeypatch, fault):
    """Four gloo ranks on the CPU; with the fault each rank keeps its own
    block of the decoded arrays and zeros for the others' (planted at
    the ranks' start-up through ``sitecustomize``)."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(NO_EXCHANGE)
    monkeypatch.setenv("PYTHONPATH", f"{site}{os.pathsep}{REPO}")
    if fault:
        monkeypatch.setenv("POSEBENCH_TEST_FAULT", fault)
    root = small_copy(tmp_path, {"workloads/thin432-mesh4-eval.json": dict(
        batch=8, scenes=8, check_images=8)})
    result = _run(root, "thin432-mesh4-eval", seconds=4.0)
    if fault:
        assert result["checks"]["humans_gap"]["value"] == 1.0
    assert result["correct"] == (fault is None)
