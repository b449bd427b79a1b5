"""The port's sharded training of dbrx-132b's smoke config (4 experts top 2)
on ``gloo`` groups of 4 CPU ranks, against the reference's sharded run on
the same mesh: (2, 2) and (1, 4) through ``moe_ep``, (2, 2) under
``fsdp``, and (2, 2) with few tokens through the sharded ``moe_dense``;
the gradients of one step and three AdamW steps
(``tests/torch_moe_train.py`` has the cases and the bounds).  Before the
repair the first backward raised in ``c10d.allreduce_`` (ROADMAP Queue
3).
"""
import pytest

from torch_moe_train import cases, check_grads, check_steps, run

ARCH = "dbrx-132b"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run(ARCH, tmp_path_factory.mktemp("moe_train"))


@pytest.mark.parametrize("case", cases(ARCH))
def test_sharded_grads_match_reference(runs, case):
    check_grads(runs, case)


@pytest.mark.parametrize("case", cases(ARCH))
def test_sharded_steps_match_reference(runs, case):
    check_steps(runs, case)
