"""The check catches a broken program, and its control: runs driven as a
real run is (the look for a card skipped), with the timed path broken
underneath, come out not correct; the control comes out far from the
reference.  CPU cases at tiny sizes; the `gpu` cases run the control at
the cell's own size on the card (`python -m pytest -m gpu
benchmark/tests/test_portbench_faults.py` there)."""

import pytest
import torch

from benchmark import control, core
from benchmark.kinds import train
from benchmark.tests import tiny

CELLS = ["sd21.episode-1shot-b8", "w8a8.episode-1shot-b8", "sd21.cached-5shot-b8"]
ALL_CELLS = CELLS + ["sd21.train-1shot-b4"]
SEED = 2 ** 36 + 11


def _invert_first_row(pipe):
    """An answer altered where it is produced: the first image inverted."""
    decode = pipe._decode_seg

    def broken(x0):
        img = decode(x0)
        img[0] = 255 - img[0]
        return img
    pipe._decode_seg = broken


def _half_batch(pipe):
    """Half of the batch computed, its rows standing in for the rest."""
    for name in ("_x0_latent", "_x0_latent_cached"):
        fn = getattr(pipe, name)

        def broken(query, *args, _fn=fn, **kw):
            h = max(1, query.shape[0] // 2)
            args = [a[:h] if torch.is_tensor(a) and a.shape[:1] == query.shape[:1] else a
                    for a in args]
            x0 = _fn(query[:h], *args, **kw)
            return torch.cat([x0] * -(-query.shape[0] // h))[:query.shape[0]]
        setattr(pipe, name, broken)


def _unet_unchanged(pipe):
    """The denoising step returns its input latent unchanged (v = −x,
    so x0 = x)."""
    pipe.unet.forward = lambda sample, *a, **kw: -sample


FAULTS = {"answer_altered": _invert_first_row, "half_batch": _half_batch,
          "state_unchanged": _unet_unchanged}


def _program(fault):
    def build(cfg, wts, dev):
        pipe = core.build_program(cfg, wts, dev)
        if fault is not None:
            FAULTS[fault](pipe)
        return pipe
    return build


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
def test_faults_come_out_not_correct(cell, fault):
    line, numbers = core.run_cell(tiny.cell(cell), SEED, 0.5, False, "cpu",
                                  program=_program(fault))
    assert line["correct"] is (fault is None), (fault, numbers)
    assert list(line)[-1] == "checked"


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_far_above_the_program(cell):
    """At tiny sizes in float32 the control's numbers lie far above the
    program's; the limits themselves are set at the cell's own size."""
    c = tiny.cell(cell)
    _, prog = core.run_cell(c, SEED, 0.5, False, "cpu")
    _, ctrl = core.run_cell(c, SEED, 4.0, False, "cpu", program=control.control_program(c))
    assert ctrl["seg_mae"] > 3 * prog["seg_mae"] and ctrl["seg_mae"] > 1.0, (prog, ctrl)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ALL_CELLS)
def test_control_fails_the_limits_on_the_card(card, cell):
    c = core.load_cell(tiny.ROOT, cell)
    line, numbers = core.run_cell(c, SEED, 4.0, False, "cuda")
    assert line["correct"], numbers
    line, numbers = core.run_cell(c, SEED, 12.0, False, "cuda",
                                  program=control.control_program(c))
    assert not line["correct"], numbers




@pytest.mark.parametrize("fault", [None] + sorted(train.FAULTS))
def test_training_faults_come_out_not_correct(fault):
    def build(cfg, traffic, wts, dev):
        t = train.PortTrainer(cfg, traffic, wts, dev)
        return t if fault is None else train.FAULTS[fault](t)

    line, numbers = core.run_cell(tiny.cell("sd21.train-1shot-b4"), SEED, 0.5, False, "cpu",
                                  program=build)
    assert line["correct"] is (fault is None), (fault, numbers)


def test_training_control_reads_far_above_the_program():
    c = tiny.cell("sd21.train-1shot-b4")
    _, prog = core.run_cell(c, SEED, 0.5, False, "cpu")
    _, ctrl = core.run_cell(c, SEED, 0.5, False, "cpu", program=control.control_program(c))
    assert ctrl["grad_gap"] > 3 * prog["grad_gap"], (prog, ctrl)
