"""A whole run of a cell on the CPU at a small size (no look for a chip),
with the program's timed path broken underneath: ``correct`` has to come
out false for each fault the cells can have, and true without one."""

import functools

import pytest
import torch

from slambench import drive, judge, run

SEED = 4294967311
CELLS = ["vlp16_lo.city_drive", "vlp16_full.city_drive"]


class _SmallCell(run.Cell):
    """The cell's files at a size a test run holds: 24 scans of 900 rays a
    beam."""

    def __init__(self, name):
        super().__init__(name)
        self.traffic = dict(self.traffic, n_scans=24)
        self.config = dict(self.config,
                           sensor=dict(self.config["sensor"], n_az=900))


@pytest.fixture(autouse=True)
def _small_and_clean(monkeypatch):
    from simpleslam_tpu_torch.utils.config import Params
    from simpleslam_tpu_torch.utils.logging import Logger

    monkeypatch.setattr(run, "Cell", _SmallCell)
    monkeypatch.setattr(run.drive_mod, "DriveJob",
                        functools.partial(drive.DriveJob, workers=2))
    monkeypatch.setattr(judge, "N_POSE", 6)
    monkeypatch.setattr(judge, "N_PREP", 2)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    Params.reset()
    Logger.reset()


def _run(cell, fault=None):
    """A whole run of the cell, with ``fault`` breaking the program's timed
    path (the warm-up's too) before it starts."""
    if fault is not None:
        fault()
    return run.run_cell(cell, SEED, 0.0, False)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = _run(cell)
    assert line["correct"], line["compared"]
    assert line["attempted"] == 24 and line["failed"] == 0


def _state_unchanged(monkeypatch):
    """Every registration returns the pose it started from."""
    from simpleslam_tpu_torch.pipeline import streamed

    orig = streamed.register_kind

    def unchanged(pc, target, init, *args):
        _, *rest = orig(pc, target, init, *args)
        return (init, *rest)

    monkeypatch.setattr(streamed, "register_kind", unchanged)


def _half_batch(monkeypatch):
    """Half of each batch's scans are left out: they take the pose of the
    last scan registered."""
    from simpleslam_tpu_torch.pipeline import streamed

    orig = streamed._batch_body

    def half(ds_stack, *args):
        h = max(1, len(ds_stack) // 2)
        chain, rows = orig(ds_stack[:h], *args)
        pad = rows[-1:].expand(len(ds_stack) - h, -1)
        return chain, torch.cat([rows, pad])

    monkeypatch.setattr(streamed, "_batch_body", half)


def _answer_altered(monkeypatch):
    """Each scan's reported pose moves 15 cm along x where it is produced
    (the pose chain itself is left as it is)."""
    from simpleslam_tpu_torch.pipeline import streamed

    orig = streamed._batch_body

    def altered(*args):
        chain, rows = orig(*args)
        rows = rows.clone()
        rows[:, 3] += 0.15
        return chain, rows

    monkeypatch.setattr(streamed, "_batch_body", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    line = _run(cell, lambda: fault(monkeypatch))
    assert not line["correct"], line["compared"]
