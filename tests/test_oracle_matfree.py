"""Dense-oracle parity, every reference energy x GN/LM, through
matrix-free J^T J (classic and pipelined PCG).

Each case steps the float64 plan and tests/oracle.py's dense re-run of
the reference algorithm side by side (tests/oracle_cases.py).
"""

import pytest

from tests.oracle_cases import check, matrix_params


@pytest.mark.parametrize("name,kind,mode",
                         matrix_params(("matfree", "pipelined")))
def test_oracle_parity_matfree(name, kind, mode):
    check(name, kind, mode)
