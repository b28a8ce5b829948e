"""CustomResourceDefinition manifest for ``TpuSlice``.

Reference analog: the controller-gen output
InstaSlice's ``config/crd/bases/inference.codeflare.dev_instaslices.yaml``
(schema for Spec.{MigGPUUUID, Allocations, Prepared, Migplacement},
Status.Processed). Generated in code here so the schema can never drift
from :mod:`instaslice_tpu_torch.api.types`.

A copy of ``instaslice_tpu/api/crd.py`` (the port imports nothing of the
JAX package): the port's CRs carry the same fields, so the manifest is
the reference's, and a GPU grid's CR fits it as it is (its ``chips`` are
GPU indices, its ``profiles`` the MIG catalog).
"""

from __future__ import annotations

from instaslice_tpu_torch.api.constants import GROUP, KIND, PLURAL, VERSION

_ALLOCATION_PROPS = {
    "allocId": {"type": "string"},
    "pods": {
        "type": "array",
        "items": {
            "type": "object",
            "properties": {
                "podUUID": {"type": "string"},
                "podName": {"type": "string"},
                "namespace": {"type": "string"},
                "workerId": {"type": "integer"},
                "handoffName": {"type": "string"},
            },
            "required": ["podUUID", "podName"],
        },
    },
    "profile": {"type": "string"},
    "torusGroup": {"type": "string"},
    "box": {"type": "string"},
    "parts": {
        "type": "object",
        "additionalProperties": {
            "type": "object",
            "properties": {
                "workerId": {"type": "integer"},
                "localBox": {"type": "string"},
            },
            "required": ["workerId", "localBox"],
        },
    },
    "status": {
        "type": "string",
        "enum": ["creating", "created", "ungated", "deleted", "failed"],
    },
    "realizedOn": {"type": "array", "items": {"type": "string"}},
    "message": {"type": "string"},
    "createdAt": {"type": "number"},
    "deletionRequestedAt": {"type": "number"},
    # observability: the grant's trace id (minted at pod admission);
    # without this property a structural-schema API server would PRUNE
    # the field on write and silently break end-to-end trace
    # propagation (docs/OBSERVABILITY.md)
    "traceId": {"type": "string"},
    # flight recorder: the persisted audit trail — last N status
    # transitions with timestamps + messages (same pruning hazard as
    # traceId; docs/OBSERVABILITY.md "Events & audit trail")
    "transitions": {
        "type": "array",
        "items": {
            "type": "object",
            "properties": {
                "status": {"type": "string"},
                "ts": {"type": "number"},
                "message": {"type": "string"},
            },
            "required": ["status", "ts"],
        },
    },
    # crash consistency: the placement-attempt epoch (docs/RECOVERY.md)
    # — a restarted controller re-places with epoch+1 so half-landed
    # copies from a crashed writer are distinguishable; pruning it
    # would silently merge stale epochs back into the cluster truth
    "attemptEpoch": {"type": "integer"},
}

_PREPARED_PART_PROPS = {
    "nodeName": {"type": "string"},
    "workerId": {"type": "integer"},
    "localBox": {"type": "string"},
    "chipIds": {"type": "array", "items": {"type": "integer"}},
    "deviceHandle": {"type": "string"},
}

_SPEC_SCHEMA = {
    "type": "object",
    "properties": {
        "generation": {"type": "string"},
        "hostOffset": {
            "type": "array",
            "items": {"type": "integer"},
            "minItems": 3,
            "maxItems": 3,
        },
        "torusGroup": {"type": "string"},
        "chips": {"type": "object", "additionalProperties": {"type": "string"}},
        "profiles": {
            "type": "array",
            "items": {
                "type": "object",
                "properties": {
                    "name": {"type": "string"},
                    "chips": {"type": "integer"},
                    "x": {"type": "integer"},
                    "y": {"type": "integer"},
                    "z": {"type": "integer"},
                    "hosts": {"type": "integer"},
                    "hbmGiB": {"type": "integer"},
                },
                "required": ["name"],
            },
        },
        "allocations": {
            "type": "object",
            "additionalProperties": {
                "type": "object",
                "properties": _ALLOCATION_PROPS,
                "required": ["allocId", "pods", "profile", "box", "status"],
            },
        },
        "prepared": {
            "type": "object",
            "additionalProperties": {
                "type": "object",
                "properties": {
                    "sliceUUID": {"type": "string"},
                    "podUUID": {"type": "string"},
                    "profile": {"type": "string"},
                    "box": {"type": "string"},
                    "parts": {
                        "type": "object",
                        "additionalProperties": {
                            "type": "object",
                            "properties": _PREPARED_PART_PROPS,
                        },
                    },
                },
                "required": ["sliceUUID", "profile", "box"],
            },
        },
    },
}

_STATUS_SCHEMA = {
    "type": "object",
    "properties": {
        "processed": {"type": "boolean"},
        "conditions": {
            "type": "array",
            "items": {"type": "object", "x-kubernetes-preserve-unknown-fields": True},
        },
        "unhealthyChips": {"type": "array", "items": {"type": "integer"}},
    },
}


def crd_manifest() -> dict:
    """The full CRD object, ready to apply/serve."""
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{PLURAL}.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {
                "kind": KIND,
                "listKind": f"{KIND}List",
                "plural": PLURAL,
                "singular": KIND.lower(),
            },
            "scope": "Namespaced",
            "versions": [
                {
                    "name": VERSION,
                    "served": True,
                    "storage": True,
                    "subresources": {"status": {}},
                    "schema": {
                        "openAPIV3Schema": {
                            "type": "object",
                            "properties": {
                                "apiVersion": {"type": "string"},
                                "kind": {"type": "string"},
                                "metadata": {"type": "object"},
                                "spec": _SPEC_SCHEMA,
                                "status": _STATUS_SCHEMA,
                            },
                        }
                    },
                    "additionalPrinterColumns": [
                        {
                            "name": "Generation",
                            "type": "string",
                            "jsonPath": ".spec.generation",
                        },
                        {
                            "name": "Group",
                            "type": "string",
                            "jsonPath": ".spec.torusGroup",
                        },
                        {
                            "name": "Processed",
                            "type": "boolean",
                            "jsonPath": ".status.processed",
                        },
                    ],
                }
            ],
        },
    }
