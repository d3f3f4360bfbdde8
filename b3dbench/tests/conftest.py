"""The benchmark's CPU tests: its own folder and the checkout's root on the
import path, as ``b3dbench/run.py`` puts them."""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (HERE, os.path.dirname(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)
