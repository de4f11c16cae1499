"""The port's copy of the metric stack (``vidchapters_tpu_torch/evals``)
gives the JAX package's ``vidchapters_tpu/evals`` results exactly (the same
floats, compared with ==) on one small synthetic submission and its
references."""

import numpy as np
import pytest

GT = {
    "vid_a": {"duration": 100.0,
              "timestamps": [[0.0, 30.0], [30.0, 62.0], [62.0, 100.0]],
              "sentences": ["We knead the dough and let it rest.",
                            "The chef folds the eggs into the flour!",
                            "Finally, the bread bakes for forty minutes."]},
    "vid_b": {"duration": 50.0,
              "timestamps": [[0.0, 20.0], [20.0, 50.0]],
              "sentences": ["Setting up the camera's tripod.", "Wrapping up -- see you soon."]},
    "vid_c": {"duration": 80.0, "timestamps": [[5.0, 40.0], [40.0, 80.0]],
              "sentences": ["intro to knots", "tying a bowline knot"]},
}
PRED = {"results": {
    "vid_a": [{"sentence": "we knead dough and rest it", "timestamp": [0.0, 28.0]},
              {"sentence": "the chef whisks eggs into flour", "timestamp": [29.0, 70.0]},
              {"sentence": "bread bakes", "timestamp": [71.0, 99.0]}],
    "vid_b": [{"sentence": "setting up a tripod", "timestamp": [1.0, 25.0]},
              {"sentence": "goodbye", "timestamp": [40.0, 50.0]}],
    "vid_c": [{"sentence": "tying knots", "timestamp": [0.0, 80.0]}],
}}
# the scorers' own input: one reference and one candidate per (video, chapter)
RES = {f"{v}_{i}": [p["sentence"]] for v, ps in PRED["results"].items()
       for i, p in enumerate(ps)}
GTS = {k: [GT[k[:5]]["sentences"][int(k[6:])]] for k in RES}


def _tokenized(mod):
    tok = mod.PTBTokenizer()
    return (tok.tokenize({k: [{"caption": c} for c in v] for k, v in GTS.items()}),
            tok.tokenize({k: [{"caption": c} for c in v] for k, v in RES.items()}))


def _run(mod, case):
    if case == "PTBTokenizer":
        return _tokenized(mod)
    if case == "eval_dvc":
        return mod.eval_dvc(PRED, [GT], seed=0)
    if case == "eval_soda":
        return mod.eval_soda(PRED, [GT])
    gts, res = _tokenized(mod)
    return getattr(mod, case)().compute_score(gts, res)


def _plain(x):
    """Nested results with numpy arrays as lists, for an exact ==."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


@pytest.mark.parametrize("case", ["Bleu", "Rouge", "Cider", "Meteor", "PTBTokenizer",
                                  "eval_dvc", "eval_soda"])
def test_port_evals_identical_to_jax_package(case):
    import vidchapters_tpu.evals as jax_evals
    import vidchapters_tpu_torch.evals as port_evals

    ref, got = _plain(_run(jax_evals, case)), _plain(_run(port_evals, case))
    assert got == ref
    if case == "eval_dvc":  # a submission that scores above zero everywhere it should
        assert ref["METEOR"] > 0 and ref["CIDEr"] > 0 and ref["Recall@0.5"] > 0
    if case == "eval_soda":
        assert ref["soda_c"] > 0
