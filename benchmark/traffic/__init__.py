"""One generator a kind of traffic, found by the name a cell gives."""
