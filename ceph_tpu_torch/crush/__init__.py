"""CRUSH placement: the map model, its structure-of-arrays form and the
rule interpreter, whose hand-written kernel is `csrc/crush_rule.cu`."""
