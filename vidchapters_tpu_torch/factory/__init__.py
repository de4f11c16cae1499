"""The ASR data factory: audio frontend, VAD, Whisper transcription, ASR pickles."""
