"""The reader of the program's ``chain_kernel`` counter
(``chain_kernel_share``), on hand-made timers: the share of every scan of
the window's drives, profiled or not, whose chain ran in the hand kernels;
a drive whose timers lack the counter (a program that books none) reads
None, not 0."""

import pytest

from slambench.test_slambench_spans import PROFILED, _read, _record


def test_chain_kernel_share_over_every_scan():
    drives = [_record(4, counters={"chain_kernel": [1.0, 1.0, 1.0, 1.0]}),
              _record(2, counters={"chain_kernel": [0.0, 1.0]},
                      session=PROFILED)]
    assert _read("chain_kernel_share", drives,
                 "vlp16_lo.city_drive") == pytest.approx(100.0 * 5 / 6)
    assert _read("chain_kernel_share", drives[:1]) == pytest.approx(100.0)


def test_chain_kernel_share_without_the_counter_reads_none():
    assert _read("chain_kernel_share", [_record(4)]) is None
    assert _read("chain_kernel_share", [
        _record(4, counters={"chain_kernel": [1.0] * 4}),
        _record(4, counters={"gn_iters": [2.0] * 4})]) is None
