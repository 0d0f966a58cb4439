"""tests/test_torch_wide.py's wide-path parity tests for BGV (its own file,
so that pytest-xdist's loadfile gives it its own worker)."""

import pytest

from .test_torch_wide import *  # noqa: F401,F403
from .test_torch_wide import WidePair


@pytest.fixture(scope="module", params=["BGV"])
def W(request):
    return WidePair(request.param)
