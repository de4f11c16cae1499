"""Training and evaluation: the entry points ``dvc_main`` (Vid2Seq chapters
and HowTo100M pretraining), ``vc_main``, ``grounding_main`` and
``pdvc_main``, their train steps and evaluators."""
