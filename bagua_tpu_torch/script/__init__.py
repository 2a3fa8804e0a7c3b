"""Cluster-level launch scripts (port of ``bagua_tpu/script``; reference ``bagua/script/``)."""
