"""Launchers (port of ``bagua_tpu/distributed``; reference ``bagua/distributed/``)."""
