"""The port's LIRA examples (``src/repro_torch/examples``) on the CPU, the
serving and training examples at reduced sizes: each ``main(device="cpu", ...)`` prints its reference's lines
(``examples/serve_ann.py``, ``examples/quickstart.py``,
``examples/train_probing_model.py``), LIRA visits no more points than IVF at
matched recall in the quickstart, and a second run of the training example
resumes at its last step and ends in the same state. At the examples' own
sizes they run on the card as ``python -m repro_torch.examples.<name>``
(``chip_smoke.py`` phase 19)."""
import re

from repro_torch.examples import quickstart, serve_ann, train_probing_model


def test_serve_ann_prints_both_tiers_and_the_frontend(capsys):
    out = serve_ann.main("cpu", n=3000, n_queries=64, n_partitions=16)
    text = capsys.readouterr().out
    assert text.startswith("building LIRA engine")
    assert re.search(r"built in \d+s; capacity=\d+; residual-PQ scan store x[\d.]+ smaller", text)
    for label in ("f32 exact scan", "residual PQ/ADC \\+ rerank"):
        assert re.search(rf"\[{label}\] \d+ QPS \(CPU\); mean nprobe=[\d.]+; dropped probes=\d+; "
                         rf"recall@10=[\d.]+", text), label
    assert re.search(r"\[front-end @1500qps offered\] p50=[\d.]+ms p99=[\d.]+ms qps=\d+ "
                     r"mean_batch=[\d.]+ shed=0; first request waited [\d.]+ms", text)
    assert out["frontend"].shed == 0
    # the quantized tier reranks 16·k slots a partition: it tracks the exact tier
    assert out["recall"]["f32"] > 0.5
    assert abs(out["recall"]["residual_pq"] - out["recall"]["f32"]) <= 0.02


def test_quickstart_lira_visits_no_more_than_ivf(capsys):
    """At the example's own sizes (20,000 points, 300 queries), which take a
    few seconds on the CPU: the claim holds at the scale the example was made
    for. At 6,000 points LIRA visits more points than IVF at matched recall
    in both packages."""
    out = quickstart.main("cpu")
    text = capsys.readouterr().out
    for step in ("1) dataset: 20k synthetic 64-d vectors", "2) K-Means partitions (B=32)",
                 "3) probing-model labels from a 8k training subset",
                 "4) train probing model", "5) learning-based redundancy",
                 "6) query-aware retrieval vs IVF at matched recall"):
        assert step in text, step
    assert re.search(r"LIRA: recall=[\d.]+ cmp=\d+ nprobe=[\d.]+", text)
    assert re.search(r"IVF : recall=[\d.]+ cmp=\d+ nprobe=[\d.]+", text)
    assert re.search(r"→ LIRA saves -?\d+% distance computations", text)
    lira, ivf = out["lira"], out["ivf"]
    assert ivf.recall >= lira.recall
    assert lira.cmp_mean <= ivf.cmp_mean


def test_train_probing_model_resumes_where_it_stopped(tmp_path, capsys):
    kw = dict(ckpt_dir=tmp_path / "ck", n=3000, n_train=1500, steps=120)
    first = train_probing_model.main("cpu", **kw)
    text = capsys.readouterr().out
    assert "starting at step 0 (0 = fresh, >0 = resumed)" in text
    assert [h["step"] for h in first] == [50, 100, 120]
    assert {"loss", "grad_norm", "step", "steps_per_s"} <= set(first[-1])
    again = train_probing_model.main("cpu", **kw)
    assert "starting at step 120 (0 = fresh, >0 = resumed)" in capsys.readouterr().out
    assert again == first
    longer = train_probing_model.main("cpu", **{**kw, "steps": 150})
    assert "starting at step 120" in capsys.readouterr().out
    assert longer[:3] == first and longer[-1]["step"] == 150
