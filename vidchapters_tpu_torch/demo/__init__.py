"""The user-facing demos: chapters (``demo_vid2seq``) and moments
(``run_on_video``) from one raw video."""
