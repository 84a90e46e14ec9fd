"""The benchmark's copy of the token generator equals the port's
``launch.train._client_round_batch`` element for element."""

import dataclasses

import numpy as np
import pytest

from phsfl_bench import feed


@pytest.mark.parametrize("arch,clients,k,micro,seq,seed", [
    ("olmoe-1b-7b", 4, 4, 2, 64, 3),
    ("seamless-m4t-medium", 4, 2, 8, 32, 2**31 + 17),
    ("olmoe-1b-7b", 16, 1, 2, 48, 4611686018427387903),
])
def test_tokens_equal_the_launchers(arch, clients, k, micro, seq, seed):
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import _client_round_batch
    cfg = get_arch(arch)
    want = _client_round_batch(cfg, clients, k, micro, seq, seed)
    got = feed.client_tokens(cfg.vocab_size, clients, (k, micro), seq, seed)
    for name in ("tokens", "labels"):
        np.testing.assert_array_equal(got[name], want[name].numpy())
        assert got[name].dtype == want[name].numpy().dtype


def test_frames_repeat_from_their_seed():
    import torch
    a = feed.frames((2, 3, 4), 9, torch.bfloat16, "cpu")
    b = feed.frames((2, 3, 4), 9, torch.bfloat16, "cpu")
    assert torch.equal(a, b) and a.dtype == torch.bfloat16
    assert not torch.equal(a, feed.frames((2, 3, 4), 10, torch.bfloat16,
                                          "cpu"))
