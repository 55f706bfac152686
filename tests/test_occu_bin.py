"""OccuBin quantizer parity vs reference golden tables (occu_bin.hpp)."""

import numpy as np

from kmcex.core.occu_bin import OccuBin


def test_occu_bin_golden(golden_core):
    for cfg in golden_core["occu_bin"]:
        ob = OccuBin(cfg["cs"] + 1, cfg["nh"])
        got_o2b = [ob.occ_to_bin(o) for o in range(cfg["cs"] + 1)]
        assert got_o2b == cfg["occ2bin"], (cfg["cs"], cfg["nh"])
        got_b2m = [ob.bin_to_mean(b) for b in range(1 << cfg["nh"])]
        assert got_b2m == cfg["bin2mean"], (cfg["cs"], cfg["nh"])


def test_occu_bin_batched_matches_scalar():
    ob = OccuBin(1024, 7)
    occ = np.arange(1024)
    np.testing.assert_array_equal(
        ob.occ_to_bin_np(occ), np.array([ob.occ_to_bin(o) for o in occ])
    )
    bins = np.arange(128)
    np.testing.assert_array_equal(
        ob.bin_to_mean_np(bins), np.array([ob.bin_to_mean(b) for b in bins])
    )
    np.testing.assert_array_equal(ob.bin2mean_lut, ob.bin_to_mean_np(bins))


def test_occu_bin_identity_region():
    ob = OccuBin(1024, 7)
    assert ob.bin_end_index1 == 32
    for occ in range(32):
        assert ob.occ_to_bin(occ) == occ
        assert ob.bin_to_mean(occ) == occ
