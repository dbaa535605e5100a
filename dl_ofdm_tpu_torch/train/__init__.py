"""Data synthesis (`Trainer.synthesize`), metrics and checkpoint I/O."""
