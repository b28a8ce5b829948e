"""Kubelet device plugin for ``nvidia.com/gpu`` and
``nvidia.com/mig-<profile>`` (port of ``instaslice_tpu/deviceplugin/``).

The JAX package's plugin rides ``grpcio`` and ``protoc``-generated
messages; the card's machine has neither, and the port imports only
torch, numpy and the standard library. So the wire is written here by
hand: the v1beta1 protobuf messages (:mod:`.proto`), HPACK
(:mod:`.hpack`, RFC 7541), HTTP/2 (:mod:`.h2`, RFC 7540) and gRPC on it
(:mod:`.wire`); the plugin's lifecycle is :mod:`.server`.
"""
