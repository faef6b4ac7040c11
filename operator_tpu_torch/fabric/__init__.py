"""The port's fleet KV fabric: so far only the pieces the router reads.

``index.py`` (which replica holds which KV blocks, fed by the router's
health board) and ``disagg.py``'s replica roles are the port's copies of
``operator_tpu/fabric``.  The PMKV1 wire, the fetch client, the peer
poller and the two-leg disaggregated dispatch are ROADMAP.md Queue 1
item 5b.
"""
