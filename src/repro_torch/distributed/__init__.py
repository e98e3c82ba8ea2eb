"""Sharded treecode (port of `repro.distributed`): RCB domain
decomposition (`rcb.py`), locally essential trees and the sharded plan
(`bltc.py`), and the executor's collectives over stacked ranks or
processes (`exchange.py`)."""
