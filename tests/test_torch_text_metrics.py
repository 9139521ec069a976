"""The port's own copies of the speaker's text metrics and vocabulary
(`eval/bleu.py`, `eval/spice.py`, `speaker/vocab.py`) against the JAX
package's, on fixed strings and on id sequences: equal numbers, exactly
(the same pure-Python arithmetic)."""
import numpy as np
import pytest

from vln_goat_tpu.eval import bleu as jbleu
from vln_goat_tpu.eval import spice as jspice
from vln_goat_tpu.speaker import vocab as jvocab
from vln_goat_tpu_torch.eval import bleu as pbleu
from vln_goat_tpu_torch.eval import spice as pspice
from vln_goat_tpu_torch.speaker import vocab as pvocab

SENTS = [
    ("walk past the dining table and turn left at the hallway",
     ["go past the table , turn left into the hall",
      "walk by the dining table then take a left down the hallway"]),
    ("go up the stairs and stop at the top",
     ["climb the staircase and wait at the top of the stairs"]),
    ("exit the bathroom through the doorway near the sink",
     ["leave the restroom by the door next to the sink"]),
    ("turn right", ["turn right and stop in front of the tv"]),
    ("", ["walk forward"]),
]


@pytest.mark.parametrize("smooth", [False, True])
def test_corpus_bleu_on_words_and_ids(smooth):
    hyps = [h.split() for h, _ in SENTS]
    refs = [[r.split() for r in rs] for _, rs in SENTS]
    assert pbleu.corpus_bleu(hyps, refs, smooth=smooth) == \
        jbleu.corpus_bleu(hyps, refs, smooth=smooth)
    rng = np.random.default_rng(0)
    ids = [list(rng.integers(3, 12, int(rng.integers(0, 9))))
           for _ in range(12)]
    rids = [[list(rng.integers(3, 12, int(rng.integers(1, 9))))]
            for _ in range(12)]
    assert pbleu.corpus_bleu(ids, rids, smooth=smooth) == \
        jbleu.corpus_bleu(ids, rids, smooth=smooth)


def test_spice_on_strings_and_ids():
    for cand, refs in SENTS:
        assert pspice.scene_graph(cand) == jspice.scene_graph(cand)
        assert pspice.spice_score(cand, refs) == \
            jspice.spice_score(cand, refs)
    data = [{"Inference": [c], "Ground Truth": r} for c, r in SENTS]
    assert pspice.SpiceScorer().compute_scores(data) == \
        jspice.SpiceScorer().compute_scores(data)
    rng = np.random.default_rng(1)
    for _ in range(10):
        h = list(rng.integers(3, 9, int(rng.integers(0, 7))))
        r = [list(rng.integers(3, 9, int(rng.integers(1, 7))))]
        assert pspice.spice_from_ids(h, r) == jspice.spice_from_ids(h, r)


def test_speaker_vocab():
    sents = [c for c, _ in SENTS] + [r for _, rs in SENTS for r in rs]
    for s in sents + ["Don't stop... go!!", "wait, then: left."]:
        assert pvocab.split_sentence(s) == jvocab.split_sentence(s)
    v = pvocab.build_vocab(sents, min_count=2)
    assert v == jvocab.build_vocab(sents, min_count=2)
    pt, jt = pvocab.SpeakerTokenizer(v, 16), jvocab.SpeakerTokenizer(v, 16)
    assert (pt.bos_id, pt.eos_id, pt.pad_id, pt.unk_id, pt.vocab_size) == \
        (jt.bos_id, jt.eos_id, jt.pad_id, jt.unk_id, jt.vocab_size)
    for s in sents:
        ids = pt.encode_sentence(s)
        assert ids == jt.encode_sentence(s)
        assert pt.decode_sentence(ids) == jt.decode_sentence(ids)
