"""The frozen counts against hand-worked values."""
from __future__ import annotations

import json

import pytest
from tiny import ROOT

from port_bench import counts

SNN = json.loads((ROOT / "port_bench/configs/2layer-snn-6400.json").read_text())
DCSNN = json.loads((ROOT / "port_bench/configs/6layer-dcsnn.json").read_text())


def test_fc_update_and_product_ops():
    assert counts.update_ops(SNN, 256, "itp") == 4 * 256 * 784 * 6400 == 5_138_022_400
    # the exact window once per pre and post counter: 4 operations each
    assert (counts.update_ops(SNN, 256, "exact") == 5_138_022_400 + 4 * 256 * (784 + 6400)
            == 5_145_378_816)
    assert counts.product_ops(SNN, 4096) == 2 * 4096 * 784 * 6400 == 41_104_179_200
    assert counts.step_ops(SNN, {"batch": 4096, "mode": "eval", "rule": "itp"}) == 41_104_179_200


def test_layer_dims_are_chip_smokes_conv_cases():
    # chip_smoke.py's CONV_CASES and COUNTER_FC_CASES at batch 16
    assert counts.layer_dims(DCSNN, 16) == [(9216, 25, 12), (1600, 108, 24), (16, 600, 128)]


def test_delta_bound_at_perfs_conv1_shape():
    # PERF.md's kernel table, row 3: DCSNN conv1 at batch 16, bound 0.00051 ms by bytes
    nbytes = 4 * (9216 * 25 + 9216 * 12) + (9216 * 25 + 9216 * 12) + 2 * 4 * 7 + 4 * 25 * 12
    assert nbytes == 1_706_216
    ms, by = counts.delta_bound(9216, 25, 12, 7, True)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert round(ms, 5) == 0.00051


def test_update_bound_of_cell_one():
    # 256 x 784 x 6400: 5.138e9 operations over 67 TFLOP/s outweigh 29.5 MB
    s = counts.update_bound_s(SNN, {"batch": 256, "rule": "itp"})
    assert s == pytest.approx(5_138_022_400 / 67e12, rel=1e-12)
