"""Enough of ``kustomize build`` for the port's tree (a copy of the
emulator in ``tools/test_deploy.py``, over the tree as data).

:func:`render` recurses a directory's ``resources`` and applies its
``patches`` as strategic merges: dicts merge key by key, ``containers``
by each item's ``name``, any other list is replaced.
"""

from __future__ import annotations

import copy
import posixpath
from typing import Dict, List

from instaslice_tpu_torch.deploy.manifests import File


def render(tree: Dict[str, File], directory: str) -> List[dict]:
    """The documents ``kubectl apply -k <directory>`` creates, in
    order."""
    (k,) = tree[posixpath.join(directory, "kustomization.yaml")][1]
    docs: List[dict] = []
    for res in k.get("resources", []):
        target = posixpath.normpath(posixpath.join(directory, res))
        if target in tree:
            docs.extend(copy.deepcopy(tree[target][1]))
        else:
            docs.extend(render(tree, target))
    for patch in k.get("patches", []):
        path = posixpath.normpath(posixpath.join(directory, patch["path"]))
        for pdoc in tree[path][1]:
            docs = [apply_patch(d, pdoc) for d in docs]
    return docs


def apply_patch(doc: dict, patch: dict) -> dict:
    """``patch`` merged into ``doc`` where kind and name match."""
    if (doc.get("kind") != patch.get("kind")
            or doc.get("metadata", {}).get("name")
            != patch.get("metadata", {}).get("name")):
        return doc
    return strategic_merge(copy.deepcopy(doc), patch)


def strategic_merge(base, patch):
    if isinstance(base, dict) and isinstance(patch, dict):
        out = dict(base)
        for key, pval in patch.items():
            if key in ("apiVersion", "kind"):
                continue
            if key == "containers" and isinstance(pval, list):
                merged = {c.get("name"): c for c in base.get(key, [])}
                for pc in pval:
                    name = pc.get("name")
                    merged[name] = strategic_merge(merged.get(name, {}), pc)
                out[key] = list(merged.values())
            elif key in base:
                out[key] = strategic_merge(base[key], pval)
            else:
                out[key] = copy.deepcopy(pval)
        return out
    return copy.deepcopy(patch)
