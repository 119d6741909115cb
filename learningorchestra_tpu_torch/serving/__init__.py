"""Serving-side pieces the catalog needs (the peer row channel).

The REST server, online batcher and AOT cache are not part of this
package yet."""
