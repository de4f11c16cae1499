"""GenBit-style gender-bias metrics over a text corpus.

Counterpart of ``vidchapters_tpu/factory/genbit.py``, a copy.

The reference runs Microsoft's GenBit over all chapter titles
(analysis/gender.py:8-21: ``GenBitMetrics('en', context_window=5,
distance_weight=0.95, percentile_cutoff=80)`` then
``add_data(chapters, tokenized=False)`` / ``get_metrics``) and reads the
``percentage_of_{male,female,non_binary}_gender_definition_words`` fields.
GenBit is not installable offline, so this module implements the same
metric family from the GenBit paper's definitions:

- distance-weighted co-occurrence counts between every regular token and
  the male/female/non-binary *gender-definition word* lists within a
  ``context_window``, each occurrence weighted ``distance_weight**(d-1)``;
- a per-token gender bias score ``ln(c_f(w) / c_m(w))`` over smoothed
  weighted counts;
- ``genbit_score`` = mean |bias| over tokens whose frequency reaches the
  ``percentile_cutoff`` percentile (rare words carry noise, not signal);
- the definition-word percentage fields the reference's analysis reads,
  plus the word-list/statistics payloads behind the same flags.

The definition word lists are compact English sets in the spirit of
GenBit's lexicons (theirs ship with the package and are longer).
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional

MALE_DEFINITION_WORDS = frozenset("""
he him his himself man men boy boys male males father fathers dad dads daddy
papa pa brother brothers son sons husband husbands uncle uncles nephew
nephews king kings prince princes sir sirs gentleman gentlemen mr
grandfather grandfathers grandpa grandson grandsons groom grooms
widower widowers actor actors lad lads guy dude bloke fella gent stepfather
stepson stepbrother godfather godson fiance boyfriend boyfriends lord lords
duke dukes earl earls baron barons emperor emperors tsar czar monk monks
wizard wizards waiter waiters steward stewards heir heirs
salesman salesmen spokesman spokesmen chairman chairmen businessman
businessmen policeman policemen fireman firemen postman postmen congressman
congressmen statesman statesmen countryman countrymen fisherman fishermen
gents schoolboy schoolboys paternal fatherhood brotherhood manhood boyhood
menfolk
""".split())

FEMALE_DEFINITION_WORDS = frozenset("""
she her hers herself woman women girl girls female females mother mothers
mom moms mommy mama ma sister sisters daughter daughters wife wives aunt
aunts niece nieces queen queens princess princesses madam madame lady ladies
mrs ms grandmother grandmothers grandma granddaughter granddaughters
bride brides widow widows actress actresses lass lasses gal gals stepmother
stepdaughter stepsister godmother goddaughter fiancee girlfriend girlfriends
duchess duchesses countess countesses baroness baronesses empress empresses
tsarina nun nuns witch witches waitress waitresses stewardess stewardesses
hostess hostesses heroine heroines heiress heiresses saleswoman saleswomen
spokeswoman spokeswomen chairwoman chairwomen businesswoman businesswomen
policewoman policewomen congresswoman congresswomen maiden maidens matron
matrons dame dames schoolgirl schoolgirls maternal motherhood sisterhood
womanhood girlhood womenfolk belle belles
""".split())

# NOTE: common-English homographs are deliberately EXCLUDED from every
# lexicon — 'miss' (verb), 'master'/'mister' (master bedroom, plain noun),
# and the neopronoun homographs 'per' (miles per hour), 'em' ('em), 've'
# ('ve) would systematically mis-gender ordinary ASR text; the genbit
# package's own lists keep to unambiguous tokens for the same reason.
NON_BINARY_DEFINITION_WORDS = frozenset("""
they them theirs themself themselves ze zir zirs ziself xe xem xyr xyrs
xemself hir hirs hirself ey eir eirs emself vis verself pers
perself fae faer faers enby enbies nonbinary non-binary genderqueer
genderfluid agender bigender demiboy demigirl pangender neutrois two-spirit
androgyne androgynous
""".split())

_TOKEN_RE = re.compile(r"[a-zA-Z][a-zA-Z'-]*")


def _tokenize(text: str) -> List[str]:
    return [t.lower() for t in _TOKEN_RE.findall(text)]


class GenBitMetrics:
    """Drop-in for the reference's usage of ``genbit.genbit_metrics
    .GenBitMetrics`` (analysis/gender.py:15-17)."""

    def __init__(self, language_code: str = "en", context_window: int = 5,
                 distance_weight: float = 0.95,
                 percentile_cutoff: int = 80):
        if language_code != "en":
            raise ValueError("only English lexicons are built in")
        self.context_window = context_window
        self.distance_weight = distance_weight
        self.percentile_cutoff = percentile_cutoff
        self._docs = 0
        self._tokens = 0
        self._male_def = 0
        self._female_def = 0
        self._nonbinary_def = 0
        self._freq: Counter = Counter()
        self._male_cooc: Dict[str, float] = defaultdict(float)
        self._female_cooc: Dict[str, float] = defaultdict(float)
        self._nonbinary_cooc: Dict[str, float] = defaultdict(float)

    # -- data ingestion ------------------------------------------------------

    def add_data(self, data: Iterable, tokenized: bool = False) -> None:
        for doc in data:
            tokens = list(doc) if tokenized else _tokenize(str(doc))
            self._docs += 1
            self._tokens += len(tokens)
            for i, tok in enumerate(tokens):
                is_m = tok in MALE_DEFINITION_WORDS
                is_f = tok in FEMALE_DEFINITION_WORDS
                is_nb = tok in NON_BINARY_DEFINITION_WORDS
                self._male_def += is_m
                self._female_def += is_f
                self._nonbinary_def += is_nb
                if is_m or is_f or is_nb:
                    continue
                self._freq[tok] += 1
                lo = max(0, i - self.context_window)
                hi = min(len(tokens), i + self.context_window + 1)
                for j in range(lo, hi):
                    if j == i:
                        continue
                    other = tokens[j]
                    w = self.distance_weight ** (abs(i - j) - 1)
                    if other in MALE_DEFINITION_WORDS:
                        self._male_cooc[tok] += w
                    elif other in FEMALE_DEFINITION_WORDS:
                        self._female_cooc[tok] += w
                    elif other in NON_BINARY_DEFINITION_WORDS:
                        self._nonbinary_cooc[tok] += w

    # -- metrics -------------------------------------------------------------

    def _frequency_cutoff(self) -> int:
        if not self._freq:
            return 0
        counts = sorted(self._freq.values())
        idx = min(len(counts) - 1,
                  int(len(counts) * self.percentile_cutoff / 100.0))
        return counts[idx]

    def _bias_scores(self) -> Dict[str, float]:
        """ln(female/male) over smoothed distance-weighted co-occurrences,
        for tokens at/above the frequency percentile cutoff that co-occur
        with gendered context at all."""
        cutoff = self._frequency_cutoff()
        scores: Dict[str, float] = {}
        for tok, n in self._freq.items():
            if n < cutoff:
                continue
            m = self._male_cooc.get(tok, 0.0)
            f = self._female_cooc.get(tok, 0.0)
            if m == 0.0 and f == 0.0:
                continue
            scores[tok] = math.log((f + 1.0) / (m + 1.0))
        return scores

    def get_metrics(self, output_statistics: bool = True,
                    output_word_list: bool = True) -> Dict:
        scores = self._bias_scores()
        total = max(self._tokens, 1)
        genbit = (sum(abs(s) for s in scores.values()) / len(scores)
                  if scores else 0.0)
        out: Dict = {
            "genbit_score": genbit,
            "percentage_of_male_gender_definition_words":
                100.0 * self._male_def / total,
            "percentage_of_female_gender_definition_words":
                100.0 * self._female_def / total,
            "percentage_of_non_binary_gender_definition_words":
                100.0 * self._nonbinary_def / total,
        }
        if output_statistics:
            out["statistics"] = {
                "num_documents": self._docs,
                "num_tokens": self._tokens,
                "frequency_cutoff": self._frequency_cutoff(),
                "num_scored_tokens": len(scores),
                "avg_bias_conditional": (
                    sum(scores.values()) / len(scores) if scores else 0.0),
            }
        if output_word_list:
            ranked = sorted(scores.items(), key=lambda kv: kv[1])
            out["token_based_metrics"] = {
                tok: {"bias": s,
                      "frequency": self._freq[tok],
                      "male_cooccurrence": self._male_cooc.get(tok, 0.0),
                      "female_cooccurrence": self._female_cooc.get(tok, 0.0)}
                for tok, s in scores.items()
            }
            out["most_male_biased"] = [t for t, _ in ranked[:10]]
            out["most_female_biased"] = [t for t, _ in ranked[-10:][::-1]]
        return out


def gender_metrics(texts: Iterable[str], context_window: int = 5,
                   distance_weight: float = 0.95,
                   percentile_cutoff: int = 80) -> Dict:
    """One-shot helper matching the reference pipeline
    (analysis/gender.py:15-21)."""
    g = GenBitMetrics("en", context_window=context_window,
                      distance_weight=distance_weight,
                      percentile_cutoff=percentile_cutoff)
    g.add_data(texts, tokenized=False)
    return g.get_metrics(output_statistics=True, output_word_list=True)
