"""The paper's zero-shot baselines: TextTiling + LLM speech chapters,
shot detection + BLIP-2 visual chapters, and zero-shot grounding."""
