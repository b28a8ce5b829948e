"""The port's deploy plane for a cluster of H100 nodes: the manifests as
data (:mod:`.manifests`), their YAML rendering and drift check
(:mod:`.gen_manifests`), a ``kustomize build`` emulator
(:mod:`.kustomize`) and the cluster-free validation (:mod:`.check`)."""
