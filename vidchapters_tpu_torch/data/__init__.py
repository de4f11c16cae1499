"""Host-side data helpers of the serving path: tokenizers, time tokens,
feature shaping."""
