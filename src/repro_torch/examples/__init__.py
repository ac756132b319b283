"""The examples of the port, each run as ``python -m
repro_torch.examples.<name> [--device cpu]`` (on ``cuda`` unless told
otherwise): ``quickstart``, ``train_lm``, ``backdoor_robustness``,
``serve_batched`` and ``nas_client_selection``."""
