import sys
from pathlib import Path

# the program under test, as run.py finds it
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
