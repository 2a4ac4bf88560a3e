"""The port's streaming metrics and retrieval metrics
(``vlp_tpu_torch/ops/metrics.py``, ``retrieval.py``) against the JAX
package's, on the CPU, from seeded numpy inputs.

Tolerances:
- the metric state (counters, both 4096-bin histograms, loss sum, count)
  from the same logits, labels, mask and loss: equal (the same fp32
  operations; the sigmoid of the bin index agrees on every input here);
  ``compute_metrics``: equal; ``auroc_exact`` and ``binary_report``: 1e-15.
- retrieval: the same ranks. Exact ties (duplicate embeddings, the padded
  columns at ``finfo.min``) rank the lower index first on both sides; the
  embeddings are ±1 on four of eight coordinates, so every normalised
  entry is ±0.5 and every similarity is exact whatever the summation
  order. The values are means of the same hits in other orders: 1e-6
  absolute, where a changed rank moves a value by at least 1 / (rows x k).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.ops import metrics as JM
from vlp_tpu.ops import retrieval as JR
from vlp_tpu_torch.ops import metrics as M
from vlp_tpu_torch.ops import retrieval as R


def _batch(rng, n):
    logits = (rng.normal(size=n) * 3).astype(np.float32)
    logits[:3] = (-40.0, 40.0, 0.0)  # the histogram's ends and its middle
    labels = rng.integers(0, 2, n).astype(np.int32)
    mask = (rng.random(n) > 0.2).astype(np.float32)
    return logits, labels, mask, np.float32(rng.random())


def _states(batches):
    js, ts = JM.init_state(), M.init_state()
    for lg, lb, m, loss in batches:
        js = JM.update_state(js, jnp.asarray(lg), jnp.asarray(lb),
                             jnp.asarray(m), jnp.asarray(loss))
        ts = M.update_state(ts, torch.from_numpy(lg), torch.from_numpy(lb),
                            torch.from_numpy(m), torch.tensor(loss))
    return js, ts


@pytest.mark.parametrize("seed", range(6))
def test_streaming_state_and_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    batches = [_batch(rng, int(rng.integers(5, 300))) for _ in range(3)]
    js, ts = _states(batches)
    for name, a, b in zip(M.BinaryMetricState._fields, js, ts):
        assert np.array_equal(np.asarray(a), b.numpy()), name
    for prefix in ("", "val/x/"):
        want = JM.compute_metrics(js, prefix)
        got = M.compute_metrics(ts, prefix)
        assert want.keys() == got.keys()
        for k in want:
            assert float(want[k]) == float(got[k]), k
    # merged states: the loaders' counters add
    js2, ts2 = _states(batches[:1])
    merged_j, merged_t = JM.merge_states(js, js2), M.merge_states(ts, ts2)
    for a, b in zip(merged_j, merged_t):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_update_without_mask_or_loss_and_a_single_class():
    lg = np.array([0.3, -2.0, 1.5], np.float32)
    lb = np.array([1, 1, 1], np.int32)
    js = JM.update_state(JM.init_state(), jnp.asarray(lg), jnp.asarray(lb))
    ts = M.update_state(M.init_state(), torch.from_numpy(lg),
                        torch.from_numpy(lb))
    for a, b in zip(js, ts):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert float(M.compute_metrics(ts)["auroc"]) == \
        float(JM.compute_metrics(js)["auroc"]) == 0.0
    assert float(M.compute_metrics(M.init_state())["accuracy"]) == 0.0


@pytest.mark.parametrize("seed", range(4))
def test_exact_auroc_and_binary_report_match_jax(seed):
    rng = np.random.default_rng(seed)
    scores = np.round(rng.random(200), 2)  # many ties
    labels = rng.integers(0, 2, 200)
    assert abs(M.auroc_exact(scores, labels)
               - JM.auroc_exact(scores, labels)) <= 1e-15
    got, want = M.binary_report(scores, labels), \
        JM.binary_report(scores, labels)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-15, k
    assert np.isnan(M.auroc_exact(scores, np.ones(200)))


def _tied_embeddings(rng, n, e=8):
    emb = np.zeros((n, e), np.float32)
    for i in range(n):
        emb[i, rng.choice(e, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
    return emb


@pytest.mark.parametrize("seed", range(5))
def test_retrieval_with_exact_ties_and_padded_rows_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, ks = 48, (3, 5, 10, 15)
    img = _tied_embeddings(rng, n)
    img[7] = img[3]
    img[9] = img[3]  # duplicates: a tie with the query itself
    txt = img[rng.permutation(n)]
    txt[10] = txt[11] = txt[12]  # duplicate captions
    labels = rng.integers(0, 3, n).astype(np.int32)
    mask = (rng.random(n) > 0.25).astype(np.float32)
    mask[3] = 0.0  # a padded row with valid duplicates
    t = lambda a: torch.from_numpy(a)
    j = lambda a: jnp.asarray(a)
    pairs = [
        (R.masked_label_precision_at_k(t(img), t(labels), t(mask), ks),
         JR.masked_label_precision_at_k(j(img), j(labels), j(mask), ks)),
        (R.masked_image_text_recall_at_k(t(img), t(txt), t(mask), ks),
         JR.masked_image_text_recall_at_k(j(img), j(txt), j(mask), ks)),
        (R.label_precision_at_k(t(img), t(labels), ks),
         JR.label_precision_at_k(j(img), j(labels), ks)),
        (R.image_text_recall_at_k(t(img), t(txt), ks),
         JR.image_text_recall_at_k(j(img), j(txt), ks))]
    for got, want in pairs:
        assert got.keys() == want.keys()
        for k in ks:
            assert abs(float(got[k]) - float(want[k])) <= 1e-6, k


def test_ties_rank_the_lower_index_first():
    sims = torch.tensor([[0.5, 1.0, 1.0, 0.5, 1.0],
                         [-1.0, -1.0, 2.0, -1.0, -1.0]])
    assert R._top(sims, 4).tolist() == [[1, 2, 4, 0], [2, 0, 1, 3]]
    import jax

    assert np.asarray(jax.lax.top_k(jnp.asarray(sims.numpy()), 4)[1]
                      ).tolist() == [[1, 2, 4, 0], [2, 0, 1, 3]]
    # masked columns sit at finfo.min together: lower index first
    emb = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.0, 1.0]])
    mask = torch.tensor([1.0, 1.0, 0.0, 0.0])
    p = R.masked_label_precision_at_k(emb, torch.tensor([0, 0, 1, 1]), mask,
                                      ks=(1,))
    assert float(p[1]) == 1.0
