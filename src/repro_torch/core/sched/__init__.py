"""Model serving scheduled HTS-style: the continuous-batching server
(:mod:`.serving`) and greedy / speculative decoding (:mod:`.specdecode`)."""
