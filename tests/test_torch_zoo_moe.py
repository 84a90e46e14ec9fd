"""Port parity for the two MoE architectures of the MoE / MLA / M-RoPE
slice: olmoe-1b-7b (MoE widened to 8 experts, top-2) and deepseek-v2-236b
(MLA, a first dense layer, then MoE widened to 8 experts, top-3, with its
shared expert), each at ``reduced(num_layers=3)``, through the checks of
``test_torch_zoo.py`` (the stages and parameter tree, the loss with the
MoE auxiliary term and its gradient, a decode loop) at its 1e-4.  A file
of their own, so that each file's share of the test run stays short.
"""

import pytest

from test_torch_zoo import (check_config_stages_and_param_tree,
                            check_decode_loop, check_loss_and_gradient,
                            zoo_setup)

ARCHS = ("olmoe-1b-7b", "deepseek-v2-236b")


@pytest.fixture(scope="module", params=ARCHS)
def zoo(request):
    return zoo_setup(request.param)


def test_config_stages_and_param_tree_match_reference(zoo):
    check_config_stages_and_param_tree(zoo)


def test_loss_and_gradient_match_reference(zoo):
    check_loss_and_gradient(zoo)


def test_decode_loop_matches_reference(zoo):
    check_decode_loop(zoo)
