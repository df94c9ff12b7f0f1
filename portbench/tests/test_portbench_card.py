"""On the card: a short run of a FastDiff cell is correct, and the control
(the reference in float8) is not, at the cell's own size."""

import pytest

from portbench import harness
from portbench.drivers.vocode import Driver
from portbench.control import readings

from .conftest import ROOT

pytestmark = pytest.mark.card


def test_short_run_is_correct(card):
    result, _ = harness.run_cell(ROOT, "fastdiff-lj.utt-b1", 2 ** 31 + 3,
                                 2.0, False, card, 0.0)
    assert result["correct"] is True, result["compared"]
    assert result["device"]["platform"] == "gpu"


def test_control_reads_above_the_limit(card):
    _, _, config, traffic = harness.resolve(ROOT, "fastdiff-lj.utt-b1")
    driver = Driver(config, traffic, 2 ** 31 + 4, card)
    driver.setup()
    driver.window(2.0, False)
    got = readings(driver)
    limit = config["limits"]["wav_rel_l2"]
    assert got["program_wav_rel_l2"] < limit < got["control_wav_rel_l2"]
