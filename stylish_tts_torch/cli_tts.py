"""``python -m stylish_tts_torch.cli_tts speak|prepare-book ...``: synthesis and
the book front end on the port."""

from .cli import tts_cli

if __name__ == "__main__":
    tts_cli()
