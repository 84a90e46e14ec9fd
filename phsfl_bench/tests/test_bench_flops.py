"""The frozen FLOP arithmetic equals the port's analytic model at the
cells' shapes."""

import dataclasses

import pytest

from phsfl_bench import flops, harness

CASES = [("olmoe4-phsfl", 2048), ("seamless-phsfl", 256),
         ("olmoe4-personalize", 2048), ("olmoe4-phsfl", 512)]


@pytest.mark.parametrize("cell,seq", CASES)
def test_forward_per_token_equals_analytic(cell, seq):
    from repro_torch.launch import analytic
    c = harness.load_cell(cell)
    prog = harness.program_config(c.config)
    assert flops.forward_per_token(c.config, seq, causal_half=True) == \
        analytic.forward_flops_per_token(prog, seq, causal_half=True)
    assert flops.forward_per_token(c.config, seq, causal_half=False) == \
        analytic.forward_flops_per_token(prog, seq, causal_half=False)


def test_train_step_is_three_forwards_less_the_head_gradient():
    c = harness.load_cell("olmoe4-phsfl").config
    f = flops.forward_per_token(c, 2048)
    head = 2 * c["d_model"] * flops.padded_vocab(c)
    assert flops.train_step_flops(c, 10, 2048) == (3 * f - head) * 10


def test_head_step_and_attention_work():
    c = harness.load_cell("olmoe4-personalize").config
    # 4 S D V a head step: the issue's 1.69 TFLOP at 2 x 2048 tokens
    assert flops.head_step_flops(c, 4096) == 4 * 4096 * 2048 * 50432
    f, b = flops.self_attention_work(2, 2048, 16, 16, 128, 128, True)
    assert f == 2 * 256 * (2048 * 2049 // 2) * 2 * 16
    assert b == 2 * 4 * 2 * 2048 * 16 * 128
