"""Host-side data: tokenizers, time tokens, feature loading, span
corruption and the dense-video-captioning dataset."""
