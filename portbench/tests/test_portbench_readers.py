"""The readers of the per-layer metrics that sum program spans: on a
synthetic window of two steps, each returns its spans' per-step sum
(seconds from ``duration_ms``, GB from the ``bytes`` attribute) and None
where its span is absent; the tune's readers take the median sweep, so a
copy only the first sweep makes leaves them."""

import pytest

from portbench import harness

#: metric -> (span it reads, what it sums: None for seconds, else the
#: attribute, read in units of 1e9).
SPAN_READERS = {
    "consolidate_s.build": ("catalog.consolidate", None),
    "design_steps_s.build": ("design.steps", None),
    "design_stack_s.build": ("design.stack", None),
    "transfer_s.build": ("runtime.put", None),
    "transfer_gb.build": ("runtime.put", "bytes"),
    "wave_setup_s.tune": ("tune.wave", None),
    "transfer_gb.tune": ("runtime.put", "bytes"),
    "design_s.image": ("design.build", None),
}


class WindowRun:
    """What a span reader reads of a traced run: its steps and spans."""

    span_seconds = harness.Run.span_seconds

    def __init__(self, spans, steps=2):
        self.spans = spans
        self.steps = [(float(i), float(i) + 1.0, f"t{i}")
                      for i in range(steps)]


def _doc(name, ms, start=0.0, **attrs):
    return {"name": name, "start": start, "duration_ms": ms,
            "attrs": attrs}


def _window(name):
    return [_doc(name, 250.0, bytes=1_232_000_000),
            _doc(name, 1500.0, bytes=44_000_000),
            _doc(name, 0.5, bytes=3_472),
            _doc("portbench.build", 9000.0),
            _doc(name + ".other", 7000.0, bytes=5_000_000_000),
            _doc("tune.rung", 4000.0, bytes=7_000_000_000)]


def test_every_span_reader_is_in_the_benchmark():
    names = {m["name"] for m in harness.load_benchmark(
        harness.BENCH_DIR.parent)["per_layer"]}
    assert set(SPAN_READERS) <= names


@pytest.mark.parametrize("metric", sorted(SPAN_READERS))
def test_reader_sums_its_spans_per_step(metric):
    name, attr = SPAN_READERS[metric]
    got = harness.reader(metric)(WindowRun(_window(name)))
    if attr is None:
        assert got == pytest.approx((0.25 + 1.5 + 0.0005) / 2, rel=1e-12)
    else:
        assert got == pytest.approx(
            (1_232_000_000 + 44_000_000 + 3_472) / 1e9 / 2, rel=1e-12)


@pytest.mark.parametrize("metric", sorted(SPAN_READERS))
def test_reader_is_silent_without_its_span(metric):
    name, _ = SPAN_READERS[metric]
    spans = [sp for sp in _window(name) if sp["name"] != name]
    assert harness.reader(metric)(WindowRun(spans)) is None
    assert harness.reader(metric)(WindowRun([], steps=3)) is None


@pytest.mark.parametrize("metric", ["transfer_gb.build", "transfer_gb.tune"])
def test_bytes_readers_skip_spans_without_bytes(metric):
    spans = [_doc("runtime.put", 10.0), _doc("runtime.put", 10.0, bytes=4e9)]
    assert harness.reader(metric)(WindowRun(spans)) == pytest.approx(2.0)
    assert harness.reader(metric)(WindowRun(spans[:1])) is None


@pytest.mark.parametrize("metric,attr", [("transfer_gb.tune", "bytes"),
                                         ("wave_setup_s.tune", None)])
def test_tune_readers_take_the_median_sweep(metric, attr):
    name = SPAN_READERS[metric][0]
    masks = 2_112_000_000 if attr else 1000.0
    # Step 0 also copies X and y, which set-up's warm-up did not; step 2
    # starts its copies a little after its own start.
    spans = [_doc(name, 600.0 if attr is None else 9.0, start=0.1,
                  bytes=1_276_000_000),
             _doc(name, masks if attr is None else 9.0, start=0.2,
                  bytes=masks)]
    spans += [_doc(name, masks if attr is None else 9.0, start=i + 0.5,
                   bytes=masks) for i in (1, 2, 3)]
    spans.append(_doc("tune.rung", 5000.0, start=1.5, bytes=9e9))
    got = harness.reader(metric)(WindowRun(spans, steps=4))
    assert got == pytest.approx(masks / 1e9 if attr else masks / 1e3,
                                rel=1e-12)
