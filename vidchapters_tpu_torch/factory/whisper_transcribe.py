"""Chunked Whisper transcription -> ``{text[], start[], end[], language}``.

Counterpart of ``vidchapters_tpu/factory/whisper_transcribe.py``
(``JaxWhisperTranscriber``) and of the reference's
asr_extract/whisper_inference.py: 30-second windows are mel-transformed
(``factory/audio``), batch-encoded, decoded with the KV cache, and segmented
by Whisper's timestamp tokens (``<|t|>`` ids >= ``TIMESTAMP_BEGIN``, 0.02 s
per step); each window then seeks to the last closed timestamp,
openai-whisper's long-form loop, with its robustness ladder: greedy (or
beam) first, then temperature fallback (0.2 .. 1.0) whenever the output
compresses too well (gzip ratio > 2.4) or scores too low (average log-prob
< -1.0), language identification at the first window, the timestamp rules,
and silent-window skipping by P(``<|nospeech|>``) at the SOT step.

The JAX ``jit`` / ``lax.scan`` programs become eager loops with the same
fixed step count (``max_decode_len - 1`` steps per decode call); nothing
inside the step loop copies to the host: ``done``, the sums and the
timestamp-rule state stay on the device. ``jax.random.categorical`` becomes
the port's Gumbel-max ``categorical`` with a ``torch.Generator`` seeded from
``(seed, window_index * 131 + rung, pick)``; jax.random's stream cannot be
reproduced, so sampled rungs are held to the JAX package by their filter and
their distribution, not by their draws.

``USE_MEGA_DECODE``: None (the default) or True decodes through
``ops/whisper_megakernel`` (the CUDA kernel for CUDA tensors, its plain
version on the CPU); False takes the standard route through the Whisper
module's ``decode_step``.
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vidchapters_tpu_torch.factory.audio import (
    HOP_LENGTH,
    N_SAMPLES,
    SAMPLE_RATE,
    log_mel_spectrogram,
)

# multilingual whisper special token ids
SOT = 50258
TRANSCRIBE = 50359
NO_TIMESTAMPS = 50363
TIMESTAMP_BEGIN = 50364
EOT = 50257
LANG_EN = 50259
NO_SPEECH = 50362
SOT_PREV = 50361  # <|startofprev|>: prefixes the rolling text prompt
TIME_PRECISION = 0.02

# the 99 contiguous language tokens <|en|>..<|su|> of the multilingual v2
# vocab, in token order (published Whisper constants)
LANG_BEGIN = LANG_EN
WHISPER_LANGUAGES: Tuple[str, ...] = (
    'en', 'zh', 'de', 'es', 'ru', 'ko', 'fr', 'ja', 'pt', 'tr', 'pl', 'ca',
    'nl', 'ar', 'sv', 'it', 'id', 'hi', 'fi', 'vi', 'he', 'uk', 'el', 'ms',
    'cs', 'ro', 'da', 'hu', 'ta', 'no', 'th', 'ur', 'hr', 'bg', 'lt', 'la',
    'mi', 'ml', 'cy', 'sk', 'te', 'fa', 'lv', 'bn', 'sr', 'az', 'sl', 'kn',
    'et', 'mk', 'br', 'eu', 'is', 'hy', 'ne', 'mn', 'bs', 'kk', 'sq', 'sw',
    'gl', 'mr', 'pa', 'si', 'km', 'sn', 'yo', 'so', 'af', 'oc', 'ka', 'be',
    'tg', 'sd', 'gu', 'am', 'yi', 'lo', 'uz', 'fo', 'ht', 'ps', 'tk', 'nn',
    'mt', 'sa', 'lb', 'my', 'bo', 'tl', 'mg', 'as', 'tt', 'haw', 'ln', 'ha',
    'ba', 'jw', 'su')

# decode route: None (default) or True = the Whisper decode kernel, False =
# the standard cached decode of the module
USE_MEGA_DECODE = None

NEG = -1e9


def language_token_for(code: str) -> int:
    """'en' -> 50259 etc.; raises on unknown codes."""
    try:
        return LANG_BEGIN + WHISPER_LANGUAGES.index(code.lower())
    except ValueError:
        raise ValueError(f"unknown Whisper language code {code!r}") from None


def language_code_for(token: int) -> str:
    """50259 -> 'en' etc.; raises on out-of-range tokens."""
    idx = token - LANG_BEGIN
    if not 0 <= idx < len(WHISPER_LANGUAGES):
        raise ValueError(f"token {token} is not a Whisper language token")
    return WHISPER_LANGUAGES[idx]


def compression_ratio(text: str) -> float:
    """Repetition detector: raw bytes / zlib bytes (whisper/utils.py)."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def detect_language_from_logits(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """SOT-step logits [B, V] -> (language token [B] int32, probability [B]):
    softmax restricted to the 99 language tokens, openai-whisper
    ``detect_language`` semantics."""
    vocab = logits.shape[-1]
    n_lang = max(0, min(LANG_BEGIN + len(WHISPER_LANGUAGES), vocab) - LANG_BEGIN)
    lang = logits[:, LANG_BEGIN:LANG_BEGIN + n_lang].float()
    probs = torch.softmax(lang, dim=-1)
    tok = (torch.argmax(lang, dim=-1) + LANG_BEGIN).to(torch.int32)
    return tok, probs.max(dim=-1).values


def apply_timestamp_rules(logits: torch.Tensor, state, is_first: bool,
                          max_initial_idx: Optional[int] = 50) -> torch.Tensor:
    """openai-whisper ``ApplyTimestampRules`` as a [N, V] float32 logits
    filter on the device:

    1. timestamps come in pairs: after a lone timestamp only a timestamp or
       EOT may follow; after a completed pair, no timestamp may;
    2. timestamps never decrease;
    3. the first sampled token is a timestamp, at most ``max_initial_idx``
       steps (0.02 s each) into the window;
    4. when the summed timestamp probability beats every text token, a
       timestamp is forced.

    ``state`` is ``(prev, prevprev, ts_last)``, int32 [N] tensors (see
    ``init_timestamp_state`` / ``update_timestamp_state``)."""
    vocab = logits.shape[-1]
    ids = torch.arange(vocab, device=logits.device)
    is_ts = ids >= TIMESTAMP_BEGIN
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    neg = torch.full((), NEG, dtype=torch.float32, device=logits.device)
    prev, prevprev, ts_last = state
    last_ts = prev >= TIMESTAMP_BEGIN
    pen_ts = prevprev >= TIMESTAMP_BEGIN
    m = torch.where((last_ts & pen_ts)[:, None] & is_ts[None], neg, zero)
    m = m + torch.where((last_ts & ~pen_ts)[:, None] & ~is_ts[None] & (ids[None] != EOT),
                        neg, zero)
    floor = torch.where(last_ts & ~pen_ts, ts_last, ts_last + 1)
    m = m + torch.where(is_ts[None] & (ids[None] < floor[:, None]), neg, zero)
    if is_first:
        bad = ~is_ts
        if max_initial_idx is not None:
            bad = bad | (ids > TIMESTAMP_BEGIN + max_initial_idx)
        m = m + torch.where(bad[None], neg, zero)
    logits = logits + m
    lp = torch.log_softmax(logits, dim=-1)
    ts_lp = torch.logsumexp(torch.where(is_ts[None], lp, neg), dim=-1)
    txt_max = torch.max(torch.where(is_ts[None], neg, lp), dim=-1).values
    force = ts_lp > txt_max
    return torch.where(force[:, None] & ~is_ts[None], neg, logits)


def init_timestamp_state(n: int, device=None):
    """prev starts at the -1 sentinel (no token sampled yet) and prevprev
    timestamp-like: openai-whisper treats a sampled sequence shorter than 2
    as penultimate_was_timestamp=True, so the forced opening timestamp is
    followed by text, not a pair-mate."""
    full = lambda v: torch.full((n,), v, dtype=torch.int32, device=device)  # noqa: E731
    return full(-1), full(TIMESTAMP_BEGIN), full(TIMESTAMP_BEGIN - 1)


def update_timestamp_state(state, nxt: torch.Tensor):
    prev, _, ts_last = state
    nxt = nxt.to(torch.int32)
    # a -1 sentinel prev means nxt is the first sampled token: the next
    # step's penultimate check must still see len < 2 => timestamp-like
    prevprev = torch.where(prev < 0, torch.full_like(prev, TIMESTAMP_BEGIN), prev)
    return nxt, prevprev, torch.where(nxt >= TIMESTAMP_BEGIN, nxt, ts_last)


def _pick_seed(seed: int, key: int, pick: int) -> int:
    """The generator seed of one sampling pick of one (window, rung)."""
    state = np.random.SeedSequence([seed, key, pick]).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


def _standard_fns(model, max_len: int):
    from vidchapters_tpu_torch.ops.decoding import DecodeFns

    def init_cache(batch: int, enc_out: torch.Tensor):
        return model.init_cache(batch, max_len, enc_out)

    def step(tokens: torch.Tensor, cache, index: int, enc_mask=None):
        return model.decode_step(tokens, cache, index)

    return DecodeFns(init_cache, step)


class WhisperTranscriber:
    """Counterpart of ``JaxWhisperTranscriber``. ``model`` is the port's
    ``Whisper`` holding its weights; the transcriber moves it to ``device``
    (CUDA unless the caller asks for the CPU).

    ``language=None`` (the default) detects the spoken language per video
    from the first 30 s window (one decoder step at SOT restricted to the 99
    language tokens) and every result carries the resolved ``language``
    code; ``language="en"`` (or ``language_token=<id>``) pins it.
    ``decode_calls`` / ``detect_calls`` count the decode programs run (each
    ``max_decode_len - 1`` decoder steps) and the language-detection steps."""

    def __init__(self, model, max_decode_len: int = 224,
                 language: Optional[str] = None,
                 language_token: Optional[int] = None,
                 decode_tokens: Optional[Callable[[List[int]], str]] = None,
                 temperatures: Tuple[float, ...] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                 compression_ratio_threshold: Optional[float] = 2.4,
                 logprob_threshold: Optional[float] = -1.0,
                 no_speech_threshold: Optional[float] = 0.6,
                 condition_on_previous_text: bool = False,
                 prompt_len: int = 64,
                 prompt_reset_on_temperature: float = 0.5,
                 seed: int = 0,
                 param_dtype: Optional[str] = None,
                 beam_size: Optional[int] = None,
                 vad: bool = False,
                 timestamp_rules: bool = True,
                 max_initial_timestamp: Optional[float] = 1.0,
                 device=None):
        from vidchapters_tpu_torch import resolve_device
        from vidchapters_tpu_torch.ops.whisper_megakernel import make_whisper_mega_fns

        self.device = resolve_device(device)
        if param_dtype is not None:
            # float parameters cast (openai-whisper decodes in fp16 on a GPU)
            model = model.to(getattr(torch, param_dtype))
        self.model = model.to(self.device).eval()
        self.max_decode_len = max_decode_len
        self.use_vad = vad
        self.decode_tokens = decode_tokens
        self.temperatures = temperatures
        self.compression_ratio_threshold = compression_ratio_threshold
        self.logprob_threshold = logprob_threshold
        self.no_speech_threshold = no_speech_threshold
        # opt-in, with a static prompt of exactly 1 + prompt_len slots
        # left-filled with <|startofprev|>, as in the JAX package
        self.condition_on_previous_text = condition_on_previous_text
        self.prompt_len = prompt_len
        self.prompt_reset_on_temperature = prompt_reset_on_temperature
        self.seed = seed
        if language is not None:
            language_token = language_token_for(language)
        self.language_token = language_token
        self.sot_sequence = [SOT, language_token if language_token is not None else LANG_EN,
                             TRANSCRIBE]
        self.beam_size = beam_size
        self.decode_calls = 0
        self.detect_calls = 0
        with torch.no_grad():
            if USE_MEGA_DECODE is None or USE_MEGA_DECODE:
                self.decode_fns = make_whisper_mega_fns(self.model, max_decode_len)
            else:
                self.decode_fns = _standard_fns(self.model, max_decode_len)
        self.vocab = model.cfg.vocab_size
        suppress = torch.zeros(self.vocab, dtype=torch.float32)
        suppress[SOT:min(NO_TIMESTAMPS + 1, self.vocab)] = NEG
        self.suppress = suppress.to(self.device)
        self.n_lang = max(0, min(LANG_BEGIN + len(WHISPER_LANGUAGES), self.vocab) - LANG_BEGIN)
        self.timestamp_rules = bool(timestamp_rules) and self.vocab > TIMESTAMP_BEGIN
        self.max_initial_idx = (None if max_initial_timestamp is None
                                else int(round(max_initial_timestamp / TIME_PRECISION)))

    # ---- device programs --------------------------------------------------

    @torch.no_grad()
    def _encode(self, mels: np.ndarray) -> torch.Tensor:
        return self.model.encode(torch.as_tensor(mels, dtype=torch.float32).to(self.device))

    @torch.no_grad()
    def _detect(self, enc: torch.Tensor):
        if self.n_lang == 0:
            raise ValueError(
                "model vocab has no language tokens (vocab_size <= "
                f"{LANG_BEGIN}); pin language=/language_token= instead")
        b = enc.shape[0]
        cache = self.decode_fns.init_cache(b, enc)
        logits, _ = self.decode_fns.step(
            torch.full((b,), SOT, dtype=torch.int32, device=self.device), cache, 0, None)
        self.detect_calls += 1
        return detect_language_from_logits(logits)

    def _rules(self, logits, state, is_first):
        return apply_timestamp_rules(logits, state, is_first, self.max_initial_idx)

    def _pick(self, logits: torch.Tensor, temperature: torch.Tensor, key: int, pick: int,
              sample: bool, ts_state=None, is_first: bool = False):
        """Greedy where temperature == 0, sampled otherwise; ``temperature``
        is a per-row [B] vector. ``sample`` (a host flag: some row's
        temperature is > 0) skips the draw when every row is greedy."""
        from vidchapters_tpu_torch.ops.decoding import categorical

        logits = logits + self.suppress
        if ts_state is not None:
            logits = self._rules(logits.float(), ts_state, is_first)
        nxt = torch.argmax(logits, dim=-1)
        if sample:
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(_pick_seed(self.seed, key, pick))
            drawn = categorical(logits / torch.clamp(temperature, min=1e-6)[:, None], gen)
            nxt = torch.where(temperature > 0, drawn, nxt)
        nxt = nxt.to(torch.int32)
        logp = torch.gather(torch.log_softmax(logits, dim=-1), 1, nxt[:, None].long())[:, 0]
        return nxt, logp

    def _prefix_scan(self, cache, tokens: torch.Tensor):
        """Feed the forced prefix through the cache: (cache, last-step logits
        float32, P(<|nospeech|>) at the SOT step, 3 from the prefix's end)."""
        batch, p_len = tokens.shape
        no_speech = torch.zeros(batch, dtype=torch.float32, device=self.device)
        logits = None
        for i in range(p_len):
            logits, cache = self.decode_fns.step(tokens[:, i], cache, i, None)
            logits = logits.float()
            if i == p_len - 3 and NO_SPEECH < self.vocab:
                no_speech = torch.softmax(logits, dim=-1)[:, NO_SPEECH]
        return cache, logits, no_speech

    @torch.no_grad()
    def _decode(self, enc: torch.Tensor, prefix: torch.Tensor, temperature: torch.Tensor,
                key: int, sample: bool):
        """Run the prefix through the cache, then ``max_decode_len - P - 1``
        more steps: (sequence [B, max_decode_len], sum of log-probs,
        generated count, no-speech probability), all on the device."""
        self.decode_calls += 1
        batch = enc.shape[0]
        cache = self.decode_fns.init_cache(batch, enc)
        p_len = prefix.shape[1]
        cache, logits, no_speech = self._prefix_scan(cache, prefix)
        rules = self.timestamp_rules
        ts_state = init_timestamp_state(batch, self.device)
        cur, sum_lp = self._pick(logits, temperature, key, 0, sample,
                                 ts_state if rules else None, is_first=True)
        ts_state = update_timestamp_state(ts_state, cur)
        n_tok = torch.ones(batch, dtype=torch.float32, device=self.device)
        done = cur == EOT
        eot = torch.full_like(cur, EOT)
        outs = []
        for i in range(self.max_decode_len - p_len - 1):
            logits, cache = self.decode_fns.step(cur, cache, p_len + i, None)
            nxt, logp = self._pick(logits.float(), temperature, key, i + 1, sample,
                                   ts_state if rules else None)
            nxt = torch.where(done, eot, nxt)
            sum_lp = sum_lp + torch.where(done, 0.0, logp)
            n_tok = n_tok + torch.where(done, 0.0, 1.0)
            done = done | (nxt == EOT)
            ts_state = update_timestamp_state(ts_state, nxt)
            outs.append(cur)
            cur = nxt
        seq = torch.cat([prefix, torch.stack(outs + [cur], dim=1)], dim=1)
        return seq, sum_lp, n_tok, no_speech

    @torch.no_grad()
    def _beam_decode(self, enc: torch.Tensor, prefix: torch.Tensor):
        """Static-shape beam search for the temperature-0 rung (faster-whisper's
        beam 5): ranking by average log-prob per token. Each example's beams
        share its cross K/V; the megakernel route defers the permutation into
        the next step's kernel."""
        from vidchapters_tpu_torch.ops.decoding import _topk_small, reorder_beam_cache

        self.decode_calls += 1
        K, b, vocab, dev = self.beam_size, enc.shape[0], self.vocab, self.device
        fns = self.decode_fns
        cache = fns.init_cache(b * K, enc)
        tok_k = torch.repeat_interleave(prefix, K, dim=0)
        p_len = prefix.shape[1]
        cache, logits, ns_k = self._prefix_scan(cache, tok_k)
        no_speech = ns_k.view(b, K)[:, 0]
        lg = (logits + self.suppress).float()
        rules = self.timestamp_rules
        if rules:
            lg = self._rules(lg, init_timestamp_state(b * K, dev), True)
        logp = torch.log_softmax(lg, dim=-1)
        first = logp.view(b, K, vocab)[:, 0]  # the beams are identical so far
        sum_lp, cur = _topk_small(first.contiguous(), K)
        max_gen = self.max_decode_len - p_len
        seqbuf = torch.zeros(b, K, max_gen, dtype=torch.int32, device=dev)
        seqbuf[:, :, 0] = cur
        done = cur == EOT
        n_tok = torch.ones(b, K, dtype=torch.float32, device=dev)
        # per-beam timestamp-rule state ([B, K]; permuted with the parents)
        ts_prev = cur
        ts_pen = torch.full((b, K), TIMESTAMP_BEGIN, dtype=torch.int32, device=dev)
        ts_last = torch.where(cur >= TIMESTAMP_BEGIN, cur,
                              torch.full_like(cur, TIMESTAMP_BEGIN - 1))
        # a finished beam persists as its own single EOT candidate
        eot_only = torch.full((vocab,), NEG, dtype=torch.float32, device=dev)
        eot_only[EOT] = 0.0
        rows = torch.arange(b, device=dev)[:, None] * K
        reorder = fns.reorder_cache or reorder_beam_cache
        eot = torch.full((b, K), EOT, dtype=torch.int32, device=dev)
        for i in range(max_gen - 1):
            logits, cache = fns.step(cur.reshape(-1), cache, p_len + i, None)
            lg = (logits + self.suppress).float()
            if rules:
                lg = self._rules(lg, (ts_prev.reshape(-1), ts_pen.reshape(-1),
                                      ts_last.reshape(-1)), False)
            logp = torch.log_softmax(lg, dim=-1).view(b, K, vocab)
            cand = torch.where(done[..., None], eot_only[None, None], logp)
            flat = (sum_lp[..., None] + cand).reshape(b, K * vocab)
            top, idx = _topk_small(flat, K)
            parent = (idx // vocab).long()
            tok = (idx % vocab).to(torch.int32)
            cache = reorder(cache, (rows + parent).reshape(-1))
            seqbuf = torch.gather(seqbuf, 1, parent[..., None].expand(-1, -1, max_gen))
            pdone = torch.gather(done, 1, parent)
            pn = torch.gather(n_tok, 1, parent)
            stored = torch.where(pdone, eot, tok)
            seqbuf[:, :, i + 1] = stored
            n_tok = pn + torch.where(pdone, 0.0, 1.0)
            done = pdone | (tok == EOT)
            ts_pen = torch.gather(ts_prev, 1, parent)
            ts_lastp = torch.gather(ts_last, 1, parent)
            ts_prev = stored
            ts_last = torch.where(stored >= TIMESTAMP_BEGIN, stored, ts_lastp)
            cur, sum_lp = tok, top
        score = sum_lp / torch.clamp(n_tok, min=1.0)
        best = torch.argmax(score, dim=1)
        pick = torch.arange(b, device=dev)
        seq = torch.cat([prefix, seqbuf[pick, best]], dim=1)
        return seq, sum_lp[pick, best], n_tok[pick, best], no_speech

    # ---- host side ----------------------------------------------------------

    def _tokens_to_text(self, tokens: List[int]) -> str:
        text_toks = [t for t in tokens if t < TIMESTAMP_BEGIN]
        if self.decode_tokens is not None:
            return self.decode_tokens(text_toks)
        return " ".join(str(t) for t in text_toks)

    def _sot_sequence(self, lang_token: Optional[int]) -> List[int]:
        return [SOT, lang_token if lang_token is not None else LANG_EN, TRANSCRIBE]

    def _prefix(self, rows: List[List[int]]) -> torch.Tensor:
        return torch.tensor(rows, dtype=torch.int32, device=self.device)

    def detect_language(self, audio: np.ndarray) -> Tuple[str, float]:
        """Language of the first 30 s window -> (code, probability)."""
        code, prob, _ = self._detect_first_window(audio)
        return code, prob

    def _detect_first_window(self, audio: np.ndarray):
        """(code, probability, window-0 encoding): the encoding is handed
        back so the first decode window reuses it."""
        if self.n_lang == 0:
            raise ValueError(
                "model vocab has no language tokens (vocab_size <= "
                f"{LANG_BEGIN}); pin language=/language_token= instead")
        mel = log_mel_spectrogram(np.asarray(audio)[:N_SAMPLES])
        enc = self._encode(mel[None])
        tok, prob = self._detect(enc)
        return language_code_for(int(tok[0])), float(prob[0]), enc

    def _resolve_language(self, audio: np.ndarray):
        """(configured-or-detected language token, window-0 encoding or None)."""
        if self.language_token is not None:
            return self.language_token, None
        if self.n_lang == 0:  # a small test vocab without language tokens
            return LANG_EN, None
        code, _, enc = self._detect_first_window(audio)
        return language_token_for(code), enc

    def _prompt_prefix(self, prompt_tokens: Optional[List[int]],
                       lang_token: Optional[int] = None) -> List[int]:
        """Static-length decode prefix: the SOT sequence, behind exactly
        ``1 + prompt_len`` <|startofprev|>-filled slots of the most recent
        transcript tokens when conditioning."""
        sot = self._sot_sequence(lang_token if lang_token is not None else self.language_token)
        if not self.condition_on_previous_text:
            return sot
        slots = [SOT_PREV] * (1 + self.prompt_len)
        tail = list(prompt_tokens or [])[-self.prompt_len:]
        if tail:
            slots[-len(tail):] = tail
        return slots + sot

    def _gate(self, toks: List[int], avg_lp: float) -> bool:
        """True when the decode needs a higher-temperature retry."""
        if (self.compression_ratio_threshold is not None
                and compression_ratio(self._tokens_to_text(toks))
                > self.compression_ratio_threshold):
            return True  # repetition loop
        return self.logprob_threshold is not None and avg_lp < self.logprob_threshold

    @staticmethod
    def _until_eot(seq: np.ndarray) -> List[int]:
        toks = []
        for t in seq:
            if t == EOT:
                break
            toks.append(int(t))
        return toks

    def _decode_window(self, mel: Optional[np.ndarray], window_index: int = 0,
                       prompt_tokens: Optional[List[int]] = None,
                       lang_token: Optional[int] = None,
                       enc: Optional[torch.Tensor] = None):
        """Temperature-fallback decode of one 30 s window (openai-whisper
        ``decode_with_fallback``); ``enc`` short-circuits the encoder.
        Returns (tokens, avg_logprob, no_speech_prob, accepted_temp)."""
        if enc is None:
            enc = self._encode(mel[None])
        prefix_list = self._prompt_prefix(prompt_tokens, lang_token)
        prefix = self._prefix([prefix_list])
        toks: List[int] = []
        avg_lp, no_speech, temp = 0.0, 0.0, 0.0
        for ti, temp in enumerate(self.temperatures):
            if temp == 0.0 and self.beam_size and self.beam_size > 1:
                seq, sum_lp, n_tok, nsp = self._beam_decode(enc, prefix)
            else:
                t = torch.full((1,), temp, dtype=torch.float32, device=self.device)
                seq, sum_lp, n_tok, nsp = self._decode(enc, prefix, t, window_index * 131 + ti,
                                                       temp > 0)
            toks = self._until_eot(seq[0].cpu().numpy()[len(prefix_list):])
            avg_lp = float(sum_lp[0]) / float(n_tok[0])
            no_speech = float(nsp[0])
            if not self._gate(toks, avg_lp):
                break
        return toks, avg_lp, no_speech, temp

    def _segments_from_tokens(self, tokens: List[int], offset: float
                              ) -> Tuple[List[dict], float]:
        """Split on timestamp-token pairs; returns (segments, seek_advance)."""
        segments = []
        cur_start = None
        cur_tokens: List[int] = []
        last_ts = 0.0
        for t in tokens:
            if t >= TIMESTAMP_BEGIN:
                ts = (t - TIMESTAMP_BEGIN) * TIME_PRECISION
                if cur_start is None:
                    cur_start = ts
                else:
                    if cur_tokens:
                        segments.append({"tokens": cur_tokens, "start": offset + cur_start,
                                         "end": offset + ts})
                    last_ts = ts
                    cur_start = None
                    cur_tokens = []
            elif cur_start is not None:
                cur_tokens.append(t)
        if cur_start is not None and cur_tokens:  # unclosed final segment
            segments.append({"tokens": cur_tokens, "start": offset + cur_start,
                             "end": offset + 30.0})
            last_ts = 30.0
        advance = last_ts if last_ts > 0 else 30.0
        return segments, advance

    def _silent(self, no_speech: float, avg_lp: float) -> bool:
        """whisper transcribe.py: a silent window, unless the log-prob says
        there is confident content."""
        return (self.no_speech_threshold is not None and no_speech > self.no_speech_threshold
                and not (self.logprob_threshold is not None
                         and avg_lp > self.logprob_threshold))

    def transcribe(self, audio: np.ndarray) -> Dict[str, list]:
        """mono float32 16 kHz audio -> ``{text[], start[], end[], language}``."""
        lang_token, enc0 = self._resolve_language(audio)
        segments: List[dict] = []
        seek = 0
        window_index = 0
        prompt: List[int] = []  # rolling committed text (conditioning only)
        vad_segs = None
        if self.use_vad:
            from vidchapters_tpu_torch.factory.vad import next_voiced_seek, speech_segments

            vad_segs = speech_segments(audio)
        while seek < len(audio):
            if vad_segs is not None:
                seek = next_voiced_seek(vad_segs, seek, N_SAMPLES, len(audio))
                if seek >= len(audio):
                    break
            window = audio[seek: seek + N_SAMPLES]
            if len(window) < SAMPLE_RATE // 2:
                break
            reuse = enc0 if seek == 0 else None  # window 0 was encoded by detection
            mel = log_mel_spectrogram(window) if reuse is None else None
            tokens, avg_lp, no_speech, temp = self._decode_window(
                mel, window_index, prompt_tokens=prompt, lang_token=lang_token, enc=reuse)
            window_index += 1
            if self._silent(no_speech, avg_lp):
                seek += N_SAMPLES
                continue
            segs, advance = self._segments_from_tokens(tokens, offset=seek / SAMPLE_RATE)
            segments.extend(segs)
            if self.condition_on_previous_text:
                if temp > self.prompt_reset_on_temperature:
                    prompt = []  # whisper: high-temperature output is not trusted
                else:
                    for seg in segs:
                        prompt.extend(seg["tokens"])
                    prompt = prompt[-self.prompt_len:]
            seek += int(advance * SAMPLE_RATE)
            if advance <= 0:
                break
        return self._result(segments, lang_token)

    def _result(self, segments: List[dict], lang_token: int) -> Dict[str, list]:
        out = {"text": [], "start": [], "end": [], "language": self._lang_code(lang_token)}
        for seg in segments:
            out["text"].append(self._tokens_to_text(seg["tokens"]).strip())
            out["start"].append(float(seg["start"]))
            out["end"].append(float(seg["end"]))
        return out

    @staticmethod
    def _lang_code(lang_token: int) -> str:
        try:
            return language_code_for(lang_token)
        except ValueError:  # a non-standard token pinned by the caller
            return "en"

    def transcribe_batch(self, audios: List[np.ndarray]) -> List[Dict[str, list]]:
        """Lockstep batched long-form transcription of several videos: every
        unfinished video's current 30 s window decodes in one batch each
        iteration. Per-row temperatures mean that a fallback retry for one
        video re-decodes the batch but raises only that video's temperature;
        accepted rows keep their first passing result. Per-video seek / skip
        semantics match ``transcribe``."""
        n = len(audios)
        if n == 0:
            return []
        seeks = [0] * n
        all_segments: List[List[dict]] = [[] for _ in range(n)]
        window_index = 0
        enc0 = None
        if self.language_token is not None or self.n_lang == 0:
            lang_tokens = [self.language_token if self.language_token is not None
                           else LANG_EN] * n
        else:  # one batched detection over every video's first window
            first = np.stack([log_mel_spectrogram(np.asarray(a)[:N_SAMPLES]) for a in audios])
            enc0 = self._encode(first)
            toks, _ = self._detect(enc0)
            lang_tokens = [int(t) for t in toks.cpu().numpy()]
        prefix_rows = [self._sot_sequence(lt) for lt in lang_tokens]
        prefix = self._prefix(prefix_rows)
        vad_segs = None
        if self.use_vad:
            from vidchapters_tpu_torch.factory.vad import next_voiced_seek, speech_segments

            vad_segs = [speech_segments(a) for a in audios]

        def active(i):
            return (seeks[i] < len(audios[i])
                    and len(audios[i]) - seeks[i] >= SAMPLE_RATE // 2)

        n_mels = self.model.cfg.num_mel_bins
        while True:
            if vad_segs is not None:
                for i in range(n):
                    if seeks[i] < len(audios[i]):
                        seeks[i] = next_voiced_seek(vad_segs[i], seeks[i], N_SAMPLES,
                                                    len(audios[i]))
            if not any(active(i) for i in range(n)):
                break
            if enc0 is not None and window_index == 0 and not any(seeks):
                enc = enc0  # detection already encoded every video's window 0
            else:
                mels = np.stack([
                    log_mel_spectrogram(audios[i][seeks[i]:seeks[i] + N_SAMPLES])
                    if active(i) else np.zeros((n_mels, N_SAMPLES // HOP_LENGTH), np.float32)
                    for i in range(n)])
                enc = self._encode(mels)
            temps = np.zeros(n, np.float32)
            accepted: List[Optional[tuple]] = [None] * n
            for ti in range(len(self.temperatures)):
                if self.beam_size and self.beam_size > 1 and not np.any(temps > 0):
                    seq, sum_lp, n_tok, nsp = self._beam_decode(enc, prefix)
                else:
                    seq, sum_lp, n_tok, nsp = self._decode(
                        enc, prefix, torch.from_numpy(temps).to(self.device),
                        window_index * 131 + ti, bool(np.any(temps > 0)))
                seq = seq.cpu().numpy()
                sum_lp, n_tok, nsp = (sum_lp.cpu().numpy(), n_tok.cpu().numpy(),
                                      nsp.cpu().numpy())
                retry = False
                for i in range(n):
                    if accepted[i] is not None or not active(i):
                        continue
                    toks = self._until_eot(seq[i, prefix.shape[1]:])
                    avg = float(sum_lp[i]) / float(n_tok[i])
                    if (not self._gate(toks, avg)
                            or self.temperatures[ti] == self.temperatures[-1]):
                        accepted[i] = (toks, avg, float(nsp[i]))
                    else:
                        temps[i] = self.temperatures[min(ti + 1, len(self.temperatures) - 1)]
                        retry = True
                if not retry:
                    break
            window_index += 1
            for i in range(n):
                if not active(i):
                    continue
                toks, avg_lp, no_speech = accepted[i]
                if self._silent(no_speech, avg_lp):
                    seeks[i] += N_SAMPLES
                    continue
                segs, advance = self._segments_from_tokens(toks, offset=seeks[i] / SAMPLE_RATE)
                all_segments[i].extend(segs)
                seeks[i] += int(advance * SAMPLE_RATE) if advance > 0 else N_SAMPLES
        return [self._result(segs, lang_tokens[i]) for i, segs in enumerate(all_segments)]
