"""Dense-oracle parity, every reference energy x GN/LM, through
the fused J^T J (use_fused_jtj).

Each case steps the float64 plan and tests/oracle.py's dense re-run of
the reference algorithm side by side (tests/oracle_cases.py).
"""

import pytest

from tests.oracle_cases import check, matrix_params


@pytest.mark.parametrize("name,kind,mode", matrix_params(("fused",)))
def test_oracle_parity_fused(name, kind, mode):
    check(name, kind, mode)
