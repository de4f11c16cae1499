"""The data factory: audio frontend, VAD, Whisper transcription and word
alignment, ASR pickles, CLIP frame features, chapter mining and annotation
preprocessing."""
