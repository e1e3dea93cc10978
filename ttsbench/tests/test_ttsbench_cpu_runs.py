"""Whole runs of the cells at a tiny size on the CPU (the harness's look
for a card skipped): the reference agrees with the port, and each fault
the cell can have, planted under the timed path, makes ``correct`` false.
On a card (``gpu``-marked), each cell's control at the cell's own size
fails a limit."""

from __future__ import annotations

import contextlib
from pathlib import Path

import pytest
import torch

from ttsbench import control
from ttsbench.harness import load_cell
from ttsbench.run import measure
from ttsbench.tests.tiny import tiny_cell

SEED = 2**31 + 101


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def run(cell, tmp_path, seed=SEED):
    return measure(cell, seed, 0.5, False, "cpu", tmp_path)


@pytest.mark.parametrize("name", ["freegan.train_acoustic", "freegan.speak_book"])
def test_reference_agrees_with_the_port(name, tmp_path):
    out = run(tiny_cell(name), tmp_path)
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    for number, row in out["checks"].items():
        assert row["value"] <= 1e-6, (number, row)


@contextlib.contextmanager
def state_unchanged():
    """The optimizer update does nothing: the step returns its state as it
    was."""
    from stylish_tts_torch.trainer import steps

    saved = steps.apply_module_update
    steps.apply_module_update = lambda module, optimizer, lr, finite=None: True
    try:
        yield
    finally:
        steps.apply_module_update = saved


@contextlib.contextmanager
def token_altered():
    """Each line is spoken with its middle token replaced by another."""
    from stylish_tts_torch.export.package import InferencePackage

    saved = InferencePackage.generate_speech

    def altered(self, tokens, *args, **kwargs):
        tokens = tokens.copy()
        i = tokens.shape[0] // 2
        tokens[i] = tokens[1] if tokens[i] != tokens[1] else tokens[2]
        return saved(self, tokens, *args, **kwargs)

    InferencePackage.generate_speech = altered
    try:
        yield
    finally:
        InferencePackage.generate_speech = saved


@pytest.mark.parametrize("name, fault", [
    ("freegan.train_acoustic", state_unchanged),
    ("freegan.train_acoustic", control.half_batch),
    ("freegan.speak_book", token_altered),
])
def test_a_planted_fault_makes_correct_false(name, fault, tmp_path):
    cell = tiny_cell(name)
    cell.checks = load_cell(name).checks
    with fault():
        out = run(cell, tmp_path)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


def fails_a_limit(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > row["limit"] for k, row in limits.items())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["freegan.train_acoustic", "freegan.speak_book",
                                  "ringformer.speak_book"])
def test_control_fails_a_limit_at_the_cells_size(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("the control at the cell's own size runs on a CUDA card")
    cell = load_cell(name)
    read = (control.control_train if cell.traffic["kind"] == "train_stage"
            else control.control_speak)
    numbers = read(cell, SEED, "cuda", Path(tmp_path))
    assert fails_a_limit(numbers, cell.checks), (numbers, cell.checks)
