"""The benchmark's tests: its own code on the CPU at a tiny size; what needs
the card is marked ``cuda`` and skips here."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent), str(HERE.parents[1] / "src")]
