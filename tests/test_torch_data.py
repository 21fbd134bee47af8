"""The port's data readers (`hhmm_tpu_torch/apps/rdata.py`,
`apps/data_io.py`, copies of the JAX package's NumPy-only modules)
against the JAX package's on the same files.

The cases mirror `tests/test_rdata.py` (hand-built RDX2 byte streams:
an xts-style matrix with attributes, NA rows and an unsorted index, an
ALTREP wrapper, an uncompressed stream and a bad magic) and
`tests/test_data_io.py` (OHLC and tick CSVs in ``tmp_path``). Each file
goes through both readers; their outputs must be equal, and the port's
must be what the JAX tests expect. The real-tick-day cases skip without
the reference's data directory, as in `tests/test_rdata.py`.
"""

import gzip
import os

import numpy as np
import pytest
import test_rdata as jr

from hhmm_tpu.apps import data_io as j_io
from hhmm_tpu.apps import rdata as j_rdata
from hhmm_tpu_torch.apps import data_io as t_io
from hhmm_tpu_torch.apps import rdata as t_rdata
from hhmm_tpu_torch.apps.hassan.data import make_dataset


def _same_ticks(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _xts(tmp_path, values, index, attrs=(), name="XYZ", compress=True):
    mat = jr._realsxp(values, attrs=jr._pairlist(
        [("dim", jr._intsxp([len(index), len(values) // len(index)])), *attrs,
         ("index", jr._realsxp(index))]))
    raw = jr._rdx2(jr._pairlist([(name, mat)]))
    p = tmp_path / f"{name}.RData"
    p.write_bytes(gzip.compress(raw) if compress else raw)
    return str(p)


class TestRData:
    def test_matrix_with_attributes(self, tmp_path):
        dimnames = ("dimnames", jr._int(19) + jr._int(2) + jr._int(254)
                    + jr._strsxp(["PRICE", "SIZE"]))
        p = _xts(tmp_path, [1.0, 2.0, 3.0, 10.0, 20.0, 30.0], [100.0, 101.0, 102.0],
                 attrs=[dimnames])
        obj, jobj = t_rdata.load_rdata(p)["XYZ"], j_rdata.load_rdata(p)["XYZ"]
        assert obj.dim == jobj.dim == (3, 2)
        assert obj.colnames() == jobj.colnames() == ["PRICE", "SIZE"]
        np.testing.assert_array_equal(obj.matrix(), jobj.matrix())
        ticks = t_rdata.load_tick_rdata(p)
        _same_ticks(ticks, j_rdata.load_tick_rdata(p))
        np.testing.assert_allclose(ticks["size"], [10.0, 20.0, 30.0])

    def test_na_rows_dropped_and_index_sorted(self, tmp_path):
        p = _xts(tmp_path, [1.0, float("nan"), 3.0, 10.0, 20.0, 30.0], [102.0, 101.0, 100.0],
                 name="A")
        ticks = t_rdata.load_tick_rdata(p)
        _same_ticks(ticks, j_rdata.load_tick_rdata(p))
        np.testing.assert_allclose(ticks["t_seconds"], [100.0, 102.0])
        np.testing.assert_allclose(ticks["price"], [3.0, 1.0])

    def test_altrep_wrap_real(self, tmp_path):
        info = (jr._int(2) + jr._symsxp("wrap_real") + jr._int(2) + jr._symsxp("base")
                + jr._int(2) + jr._intsxp([14]) + jr._int(254))
        state = (jr._int(2) + jr._realsxp([3.0, 1.0, 2.0]) + jr._int(2) + jr._intsxp([0, 0])
                 + jr._int(254))
        altrep = jr._int(238) + info + state + jr._int(254)
        p = tmp_path / "alt.RData"
        p.write_bytes(gzip.compress(jr._rdx2(jr._pairlist([("v", altrep)]))))
        got = np.asarray(t_rdata.load_rdata(str(p))["v"].values)
        np.testing.assert_array_equal(got, np.asarray(j_rdata.load_rdata(str(p))["v"].values))
        np.testing.assert_allclose(got, [3.0, 1.0, 2.0])

    def test_uncompressed_and_bad_magic(self, tmp_path):
        p = tmp_path / "plain.RData"
        p.write_bytes(jr._rdx2(jr._pairlist([("v", jr._realsxp([1.0]))])))
        assert list(t_rdata.load_rdata(str(p))) == list(j_rdata.load_rdata(str(p))) == ["v"]
        bad = tmp_path / "bad.RData"
        bad.write_bytes(b"not an rdata file")
        for reader in (t_rdata.load_rdata, j_rdata.load_rdata):
            with pytest.raises(ValueError, match="RDX"):
                reader(str(bad))


@pytest.mark.skipif(not os.path.exists(jr.REF_DAY), reason="reference data not mounted")
def test_real_tick_day():
    _same_ticks(t_rdata.load_tick_rdata(jr.REF_DAY), j_rdata.load_tick_rdata(jr.REF_DAY))


OHLC = ("Date,Open,High,Low,Close,Volume\n"
        "2005-01-03,16.0,16.5,15.8,16.2,1000\n"
        "2005-01-04,16.2,16.4,15.9,16.0,1200\n")


class TestCSV:
    @pytest.mark.parametrize("text,want", [
        (OHLC, [[16.0, 16.5, 15.8, 16.2], [16.2, 16.4, 15.9, 16.0]]),
        ("date,adj.close,open,high,low,close\n2005-01-03,15.0,16.0,16.5,15.8,16.2\n",
         [[16.0, 16.5, 15.8, 16.2]]),
    ])
    def test_ohlc(self, tmp_path, text, want):
        p = tmp_path / "luv.csv"
        p.write_text(text)
        got = t_io.load_ohlc_csv(str(p))
        np.testing.assert_array_equal(got, j_io.load_ohlc_csv(str(p)))
        np.testing.assert_allclose(got, want)

    def test_ohlc_feeds_make_dataset(self, tmp_path):
        p = tmp_path / "luv.csv"
        p.write_text(OHLC)
        ds = make_dataset(t_io.load_ohlc_csv(str(p)), scale=False)
        np.testing.assert_allclose(ds.x, [16.0])
        np.testing.assert_allclose(ds.u, [[16.0, 16.5, 15.8, 16.2]])

    @pytest.mark.parametrize("loader,text,match", [
        ("load_ohlc_csv", "open,high,low,close\n10,9,11,10\n", "high < low"),
        ("load_ohlc_csv", "open,high,low\n1,2,3\n", "close"),
        ("load_ticks_csv", "time,price,size\n5,20.0,1\n3,20.1,2\n", "not sorted"),
    ])
    def test_rejects(self, tmp_path, loader, text, match):
        p = tmp_path / "bad.csv"
        p.write_text(text)
        for io in (t_io, j_io):
            with pytest.raises(ValueError, match=match):
                getattr(io, loader)(str(p))

    @pytest.mark.parametrize("text,want", [
        ("time,price,size\n09:30:00,20.00,100\n09:30:01.5,20.01,50\n09:30:03,20.00,75\n",
         [34200.0, 34201.5, 34203.0]),
        ("time,price,size\n0,20.0,1\n2.5,20.1,2\n", [0.0, 2.5]),
    ])
    def test_ticks(self, tmp_path, text, want):
        p = tmp_path / "t.csv"
        p.write_text(text)
        got = t_io.load_ticks_csv(str(p))
        _same_ticks(got, j_io.load_ticks_csv(str(p)))
        np.testing.assert_allclose(got["t_seconds"], want)

    def test_day_directory(self, tmp_path):
        for day, px in (("2007.05.02", 20.0), ("2007.05.01", 19.0)):
            (tmp_path / f"G.TO.{day}.csv").write_text(
                f"time,price,size\n1,{px},10\n2,{px + 0.01},20\n")
        days = t_io.load_tick_days(str(tmp_path), symbol="G.TO")
        jdays = j_io.load_tick_days(str(tmp_path), symbol="G.TO")
        assert len(days) == len(jdays) == 2
        for d, jd in zip(days, jdays):
            _same_ticks(d, jd)
        assert [d["price"][0] for d in days] == [19.0, 20.0]

    def test_day_directory_empty(self, tmp_path):
        for io in (t_io, j_io):
            with pytest.raises(ValueError, match="no matching"):
                io.load_tick_days(str(tmp_path))
