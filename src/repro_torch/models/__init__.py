"""The LM substrate's models: ``layers`` and ``transformer``."""
