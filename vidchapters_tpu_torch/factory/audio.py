"""Audio frontend for Whisper: log-mel spectrograms, pure numpy.

The port's own copy of ``vidchapters_tpu/factory/audio.py``.

Matches OpenAI Whisper's frontend (librosa-compatible slaney-normalized mel
filterbank, N_FFT=400, HOP=160, 80 mels, 16 kHz): stft magnitude^2 -> mel ->
log10 -> clamp to (max - 8) -> (x + 4) / 4. No data files needed — the
filterbank is computed analytically.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
CHUNK_LENGTH = 30  # seconds
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000


def hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (linear below 1 kHz, log above)."""
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mel)


def mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sr: int = SAMPLE_RATE, n_fft: int = N_FFT,
                   n_mels: int = N_MELS) -> np.ndarray:
    """[n_mels, n_fft//2 + 1] slaney-normalized triangular filters."""
    fft_freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


_FILTERS = None


def log_mel_spectrogram(audio: np.ndarray, pad_to_chunk: bool = True
                        ) -> np.ndarray:
    """float32 mono 16 kHz audio -> [80, frames] Whisper log-mel."""
    global _FILTERS
    if _FILTERS is None:
        _FILTERS = mel_filterbank()
    if pad_to_chunk:
        if len(audio) > N_SAMPLES:
            audio = audio[:N_SAMPLES]
        audio = np.pad(audio, (0, N_SAMPLES - len(audio)))
    # reflect-padded framed STFT with a Hann window (torch.stft(center=True))
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float64)
    padded = np.pad(audio.astype(np.float64), (N_FFT // 2, N_FFT // 2),
                    mode="reflect")
    n_frames = 1 + (len(padded) - N_FFT) // HOP_LENGTH
    idx = (np.arange(N_FFT)[None, :]
           + HOP_LENGTH * np.arange(n_frames)[:, None])
    frames = padded[idx] * window[None, :]
    spec = np.fft.rfft(frames, axis=1)
    magnitudes = (np.abs(spec) ** 2).T[:, :-1]  # drop the last frame
    mel = _FILTERS @ magnitudes.astype(np.float32)
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def load_audio(path: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """File -> float32 mono audio at ``sr``.

    The reference leans on ``whisper.load_audio`` (an ffmpeg subprocess,
    demo_asr.py:18). Here: ``.npy`` arrays and PCM ``.wav`` load natively
    (stdlib ``wave`` + linear resample), anything else shells out to ffmpeg
    when available.
    """
    if path.endswith(".npy"):
        audio = np.load(path).astype(np.float32)
        return audio.mean(axis=1) if audio.ndim == 2 else audio
    if path.endswith(".wav"):
        import wave

        with wave.open(path, "rb") as w:
            n, width, rate = w.getnframes(), w.getsampwidth(), w.getframerate()
            channels = w.getnchannels()
            raw = w.readframes(n)
        if width == 2:
            audio = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        elif width == 4:
            audio = np.frombuffer(raw, np.int32).astype(np.float32) / 2**31
        elif width == 1:
            audio = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128) / 128
        else:
            raise ValueError(f"unsupported wav sample width {width}")
        if channels > 1:
            audio = audio.reshape(-1, channels).mean(axis=1)
        if rate != sr:
            t = np.arange(int(len(audio) * sr / rate)) * (rate / sr)
            audio = np.interp(t, np.arange(len(audio)), audio).astype(np.float32)
        return audio
    import shutil
    import subprocess

    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            f"loading {path} needs ffmpeg (not installed); provide .wav/.npy")
    out = subprocess.run(
        ["ffmpeg", "-nostdin", "-i", path, "-f", "s16le", "-ac", "1",
         "-acodec", "pcm_s16le", "-ar", str(sr), "-"],
        capture_output=True, check=True).stdout
    return np.frombuffer(out, np.int16).astype(np.float32) / 32768.0
