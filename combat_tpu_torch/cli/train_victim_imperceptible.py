"""Imperceptible victim: the reference ``train_victim_imperceptible.py`` is
the same script as ``train_victim.py``, so this entry point is an alias of
the base victim (as ``combat_tpu/cli/train_victim_imperceptible.py`` is)."""

from .train_victim import main, run  # noqa: F401

if __name__ == "__main__":
    main()
