"""One module per kind of traffic, named by a mix's ``kind`` key."""
