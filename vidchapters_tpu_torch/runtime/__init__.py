"""Runtime helpers of the training path."""
