"""``correct`` against the cells' own limits: a sound run passes, and a
run with the timed path broken underneath, or the control in the
program's place, fails. Small CPU runs drive everything but the look for
a card; the program runs in float32 there, whose gaps to the reference
are rounding (the card's bf16 readings set the limits, PERF.md)."""

import pytest

from gpubench import faults, layout
from gpubench.testing import run_small, small

CELLS = [w["name"] for w in layout.benchmark()["workloads"]]
KIND = {name: layout.cell(name)["traffic"]["kind"] for name in CELLS}
FAULTS = [(name, f) for name in CELLS
          for f in (faults.SERVE if KIND[name] == "serve" else faults.TRAIN)]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, _, _ = run_small(name, precision="float32")
    assert result["correct"], result["checks"]
    assert result["failed"] == 0


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=["{}-{}".format(*f) for f in FAULTS])
def test_fault_is_not_correct(name, fault):
    table = faults.SERVE if KIND[name] == "serve" else faults.TRAIN
    result, _, err = run_small(name, fault=table[fault],
                               precision="float32")
    assert not result["correct"], result["checks"]
    # each compared number is printed beside its limit, last on stderr
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") and "(limit " in line
               for line in tail)


@pytest.mark.parametrize("name", [n for n in CELLS if KIND[n] == "serve"])
def test_control_fails_a_limit(name):
    from gpubench.control import readings

    info = small(name)
    numbers = readings(name, 11, "fp8", device="cpu", info=info)
    assert any(numbers[k] > v for k, v in info["limits"].items()
               if k in numbers), numbers


@pytest.mark.parametrize("name", [n for n in CELLS if KIND[n] == "train"])
def test_training_control_reads_above_the_program(name):
    """At the CPU's size (batches of 8) the training gaps are not those of
    batch 1,024 that set the limits, so the control is held against the
    program's bf16 run on the same seeds: it reads higher."""
    from gpubench.control import readings

    info = small(name)
    for seed in (11, 12, 13):
        program = readings(name, seed, "program", device="cpu", info=info)
        control = readings(name, seed, "fp8", device="cpu", info=info)
        assert control["loss_gap"] > 3 * program["loss_gap"], seed
        assert control["grad_gap"] > program["grad_gap"], seed


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    from gpubench.control import readings

    limits = layout.cell(name)["limits"]
    for seed in (101, 102, 103):
        numbers = readings(name, seed, "fp8")
        assert any(numbers[k] > v for k, v in limits.items()
                   if k in numbers), (seed, numbers)


@pytest.mark.parametrize("name", [n for n in CELLS if KIND[n] == "train"])
def test_witnesses_of_the_training_look(name):
    """The program's float32 path follows the reference in the first
    gradient's direction, and bf16 rounding of the reference alone moves
    that direction a hundred times further: the witnesses behind the
    numbers a training cell leaves out (PERF.md)."""
    from gpubench.control import readings

    info = small(name)
    f32 = readings(name, 11, "program_float32", device="cpu", info=info)
    bf16 = readings(name, 11, "bf16", device="cpu", info=info)
    assert f32["grad_dir"] < 1e-4 and f32["loss_gap"] < 1e-5, f32
    assert bf16["grad_dir"] > 100 * max(f32["grad_dir"], 1e-6), bf16
