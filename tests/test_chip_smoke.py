"""chip_smoke.py off the card: it refuses a CPU, and its phases' checks
run at toy size (the card runs them at full width)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu()


def test_main_fails_without_result_line(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("name", ["toy", "toy_t2"])
def test_step_and_chain_checks_pass_on_toy(name):
    chip_smoke.check_step_extproduct(name, rows=4, batch=16)
    assert chip_smoke.check_chain(name, batch=16) > 0


def test_protocol_vectors_genuine_then_impostor():
    probe, templates = chip_smoke.protocol_vectors(
        np.random.default_rng(0), 4, nslots=128, bitsize=8)
    assert templates.shape == (4, 128)
    assert ((templates >= 1) & (templates <= 255)).all() and (probe >= 2).all()
    assert [chip_smoke.mirror_decision(t, probe, 256) for t in templates[:2]] == [0, 0]
    assert chip_smoke.mirror_decision(templates[2], probe, 256) == 1


@pytest.mark.gpu
def test_step_extproduct_at_t2_width_on_card(gpu):
    chip_smoke.check_step_extproduct("peba1_128_t2")


def test_four_card_phase_on_virtual_devices():
    """Phase 5's checks (dp=4 identify, tp=4 ring bootstrap, each against
    its one-device run and the plaintext mirror) on 4 of the virtual CPU
    devices, at toy width."""
    from peba1.params import ProtocolParams
    chip_smoke.check_four_cards(
        "toy", ring="toy_t2",
        proto=ProtocolParams(nslots=2, bitsize=3, max_bitsize=9, mul_width=8,
                             bound_match=4))
