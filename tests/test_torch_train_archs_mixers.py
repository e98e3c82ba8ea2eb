"""Training the LM architectures whose blocks are not the decoder-only
transformer's (SSM, hybrid, encoder-decoder, VLM) on the port, held
against `repro` on the CPU at their SMOKE configs: the per-arch tests of
`tests/test_torch_train_archs.py` (its docstring gives the bars), run
here on these archs."""
import pytest

from repro.configs.registry import ARCH_IDS
from test_torch_train_archs import (  # noqa: F401 (the tests run here too)
    TRANSFORMERS, _one_torch_thread, arch_case,
    test_grad_accum_equals_full_batch, test_loss_and_grads_match_reference,
    test_remat_gives_the_same_grads,
    test_step_from_the_references_optimizer_state,
    test_three_train_steps_match_reference)

MIXERS = tuple(a for a in ARCH_IDS if a not in TRANSFORMERS)


@pytest.fixture(scope="module", params=MIXERS)
def arch(request):
    return arch_case(request.param)
