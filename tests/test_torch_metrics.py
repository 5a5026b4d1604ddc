"""repro_torch.metrics against repro.metrics: every case of
tests/test_metrics.py on the port (CSVLogger resume/append semantics, the
obs-registry mirror, MetricTracker windows), and the two packages' loggers
writing the same rows to byte-identical files."""
import pytest

pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
from repro.metrics import CSVLogger as JCSVLogger  # noqa: E402
from repro.metrics import MetricTracker as JMetricTracker  # noqa: E402

import repro_torch.obs as obs  # noqa: E402
from repro_torch.metrics import (CSVLogger, MetricTracker,  # noqa: E402
                                 MetricsRegistry)


@pytest.fixture(autouse=True)
def _ambient_off():
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def _lines(path):
    return open(path).read().strip().splitlines()


def test_csv_logger_writes_header_once(tmp_path):
    path = str(tmp_path / "m.csv")
    lg = CSVLogger(path)
    lg.log(0, {"loss": 1.0, "acc": 0.5})
    lg.log(1, {"loss": 0.9, "acc": 0.6})
    lg.close()
    assert _lines(path) == ["step,acc,loss", "0,0.5,1.0", "1,0.6,0.9"]


def test_csv_logger_resume_appends_instead_of_clobbering(tmp_path):
    path = str(tmp_path / "m.csv")
    first = CSVLogger(path)
    first.log(0, {"loss": 1.0})
    first.close()
    resumed = CSVLogger(path)
    resumed.log(1, {"loss": 0.5})
    resumed.close()
    assert _lines(path) == ["step,loss", "0,1.0", "1,0.5"]


def test_csv_logger_rejects_unknown_keys(tmp_path):
    path = str(tmp_path / "m.csv")
    lg = CSVLogger(path)
    lg.log(0, {"loss": 1.0})
    with pytest.raises(ValueError, match=r"row keys \['extra'\]"):
        lg.log(1, {"loss": 0.5, "extra": 2.0})
    lg.close()


def test_csv_logger_rejects_mismatched_fieldnames_on_resume(tmp_path):
    path = str(tmp_path / "m.csv")
    first = CSVLogger(path)
    first.log(0, {"loss": 1.0})
    first.close()
    other = CSVLogger(path, fieldnames=["step", "other"])
    with pytest.raises(ValueError, match="do not match the existing header"):
        other.log(1, {"other": 2.0})


def test_csv_logger_missing_fields_stay_empty(tmp_path):
    path = str(tmp_path / "m.csv")
    lg = CSVLogger(path, fieldnames=["step", "loss", "acc"])
    lg.log(0, {"loss": 1.0})
    lg.close()
    assert _lines(path) == ["step,loss,acc", "0,1.0,"]


def test_csv_logger_mirrors_into_ambient_registry(tmp_path):
    tel = obs.enable()
    lg = CSVLogger(str(tmp_path / "m.csv"))
    lg.log(0, {"loss": 1.0})
    lg.log(1, {"loss": 0.25})
    lg.close()
    assert tel.metrics.snapshot()["log.loss"] == 0.25


def test_metrics_reexports_registry_types():
    assert MetricsRegistry is obs.MetricsRegistry


def test_metric_tracker_empty_window():
    tr = MetricTracker(window=3)
    assert tr.means() == {}
    tr.update({})
    assert tr.means() == {}


def test_metric_tracker_window_eviction():
    tr = MetricTracker(window=2)
    for v in (1.0, 2.0, 3.0, 4.0):
        tr.update({"loss": v})
    assert tr.means() == {"loss": 3.5}
    tr.update({"other": 7.0})
    assert tr.means()["other"] == 7.0


ROWS = [{"loss": 1.0, "acc": 0.5}, {"loss": 0.3333333432674408, "acc": 1e-7},
        {"loss": float("inf"), "acc": 0.0}, {"loss": 2.5e-12, "acc": 1}]


@pytest.mark.parametrize("fieldnames", [None, ["step", "loss", "acc",
                                               "eps"]])
def test_both_loggers_write_byte_identical_files(tmp_path, fieldnames):
    """The same rows through both packages' CSVLogger — across a resume —
    give the same bytes (header order, number formatting, empty cells)."""
    paths = {}
    for name, cls in (("port", CSVLogger), ("ref", JCSVLogger)):
        path = paths[name] = str(tmp_path / f"{name}.csv")
        lg = cls(path, fieldnames=fieldnames)
        for step, row in enumerate(ROWS[:2]):
            lg.log(step, row)
        lg.close()
        lg = cls(path)
        for step, row in enumerate(ROWS[2:], start=2):
            lg.log(step, row)
        lg.close()
    with open(paths["port"], "rb") as a, open(paths["ref"], "rb") as b:
        assert a.read() == b.read()


def test_both_trackers_give_the_same_means():
    ours, theirs = MetricTracker(window=3), JMetricTracker(window=3)
    for row in ROWS:
        ours.update(row)
        theirs.update(row)
    assert ours.means() == theirs.means()
