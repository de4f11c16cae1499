"""Vid2Seq model modules: T5, temporal ViT, their fusion, weight import."""
