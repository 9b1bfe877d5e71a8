"""A conformant in-process Kubernetes apiserver for the REST tier.

The reference proves its engine against a REAL kube-apiserver via envtest
(upgrade_suit_test.go:77-82: apiserver + etcd binaries, no kubelet).  No
Kubernetes control-plane binaries exist in this environment, so this
module provides the equivalent verification boundary the stdlib way: an
HTTP server that speaks the exact wire subset ``rest.RestClient`` uses —
typed-object JSON, strategic-merge/merge patches with ``null``-deletes,
label/field selectors, list envelopes, Status error bodies, the policy/v1
Eviction subresource with PodDisruptionBudget 429 semantics — backed by
the same object store the simulation tier uses.

What this buys over calling FakeCluster directly: the full
serialize → HTTP → parse → verb → serialize → parse round trip runs for
every engine call, so a field the client forgets to serialize, a patch
content-type mismatch, or a Status body the client can't classify fails a
test instead of surfacing on a real cluster.  The e2e rolling-upgrade
suite runs unchanged against (engine → RestClient → this server), and a
shared conformance suite pins FakeCluster and RestClient-over-server to
identical verb semantics (tests/test_apiserver_tier.py).
"""

from __future__ import annotations

import datetime
import json
import socket
import struct
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from k8s_operator_libs_tpu_torch.consts import get_logger
from k8s_operator_libs_tpu_torch.k8s.client import (
    ConflictError,
    EvictionBlockedError,
    ExpiredError,
    FakeCluster,
    InvalidError,
    NotFoundError,
    ServerError,
    ThrottledError,
)
from k8s_operator_libs_tpu_torch.k8s.faults import Fault, FaultSchedule
from k8s_operator_libs_tpu_torch.k8s.objects import (
    ControllerRevision,
    DaemonSet,
    Node,
    Pod,
)
from k8s_operator_libs_tpu_torch.k8s.rest import daemon_set_from_json
from k8s_operator_libs_tpu_torch.k8s.selectors import matches_selector

logger = get_logger(__name__)


# --- typed object -> JSON (the server side of rest.py's *_from_json) --------


def _iso(ts: Optional[float]) -> Optional[str]:
    if ts is None:
        return None
    return (
        datetime.datetime.fromtimestamp(ts, datetime.timezone.utc)
        .isoformat()
        .replace("+00:00", "Z")
    )


def _meta_to_json(meta) -> dict:
    out = {
        "name": meta.name,
        "uid": meta.uid,
        "resourceVersion": str(meta.resource_version),
        "labels": dict(meta.labels),
        "annotations": dict(meta.annotations),
        "creationTimestamp": _iso(meta.creation_timestamp),
    }
    if meta.namespace:
        out["namespace"] = meta.namespace
    if meta.deletion_timestamp is not None:
        out["deletionTimestamp"] = _iso(meta.deletion_timestamp)
    if meta.owner_references:
        out["ownerReferences"] = [
            {
                "name": o.name,
                "uid": o.uid,
                "kind": o.kind,
                "apiVersion": "apps/v1",
                "controller": o.controller,
            }
            for o in meta.owner_references
        ]
    return out


def node_to_json(node: Node) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": _meta_to_json(node.metadata),
        "spec": {"unschedulable": node.spec.unschedulable},
        "status": {
            "conditions": [
                {"type": c.type, "status": c.status}
                for c in node.status.conditions
            ]
        },
    }


def pod_to_json(pod: Pod) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": _meta_to_json(pod.metadata),
        "spec": {
            "nodeName": pod.spec.node_name,
            "volumes": [
                {"name": v.name, **({"emptyDir": {}} if v.empty_dir else {})}
                for v in pod.spec.volumes
            ],
        },
        "status": {
            "phase": pod.status.phase,
            "containerStatuses": [
                {
                    "name": c.name,
                    "ready": c.ready,
                    "restartCount": c.restart_count,
                }
                for c in pod.status.container_statuses
            ],
            "initContainerStatuses": [
                {
                    "name": c.name,
                    "ready": c.ready,
                    "restartCount": c.restart_count,
                }
                for c in pod.status.init_container_statuses
            ],
        },
    }


def daemon_set_to_json_full(ds: DaemonSet) -> dict:
    """Server-side DS rendering: unlike the client's create/update body
    (rest.daemon_set_to_json) this carries uid/resourceVersion and the
    status the engine's completeness guard reads
    (DesiredNumberScheduled, upgrade_state.go:243-246)."""
    return {
        "apiVersion": "apps/v1",
        "kind": "DaemonSet",
        "metadata": _meta_to_json(ds.metadata),
        "spec": {
            "selector": {"matchLabels": dict(ds.spec.selector.match_labels)},
            "updateStrategy": {"type": ds.spec.update_strategy},
            "template": {
                "metadata": {
                    "labels": dict(ds.spec.template.labels),
                    "annotations": dict(ds.spec.template.annotations),
                },
                "spec": dict(ds.spec.template.pod_spec),
            },
        },
        "status": {
            "desiredNumberScheduled": ds.status.desired_number_scheduled
        },
    }


def controller_revision_to_json(rev: ControllerRevision) -> dict:
    return {
        "apiVersion": "apps/v1",
        "kind": "ControllerRevision",
        "metadata": _meta_to_json(rev.metadata),
        "revision": rev.revision,
    }


def _status_body(
    code: int, reason: str, message: str, causes: Optional[list] = None
) -> dict:
    """metav1.Status, real-apiserver shape: 2xx codes carry
    ``status: Success`` (and no Failure ``reason``); errors carry
    ``status: Failure`` + a machine-readable reason.  Clients that
    switch on ``status``/``reason`` (client-go's error helpers do) would
    misclassify a body that says Failure on a successful eviction."""
    success = code < 400
    body = {
        "apiVersion": "v1",
        "kind": "Status",
        "metadata": {},
        "status": "Success" if success else "Failure",
        "code": code,
        "message": message,
    }
    if not success:
        body["reason"] = reason
    if causes:
        body["details"] = {"causes": causes}
    return body


class _Handler(BaseHTTPRequestHandler):
    """Routes the API subset rest.RestClient speaks onto the store."""

    protocol_version = "HTTP/1.1"
    server_version = "tpu-operator-apiserver/1.0"
    # Small keep-alive responses + Nagle + the client's delayed ACK cost
    # a flat ~40 ms per exchange; a real apiserver (Go net/http) runs
    # with TCP_NODELAY for the same reason.
    disable_nagle_algorithm = True

    # Set by KubeApiServer.
    store: FakeCluster = None  # type: ignore[assignment]
    stopping: threading.Event = None  # type: ignore[assignment]
    # Optional FaultSchedule: consulted per request (and per watch-stream
    # iteration) to synthesize the wire shape of injected faults.
    faults: Optional[FaultSchedule] = None

    def log_message(self, fmt, *args):  # noqa: D102 — silence stdlib logging
        logger.debug("apiserver: " + fmt, *args)

    # -- plumbing -----------------------------------------------------------

    def _send(
        self, code: int, body: dict, headers: Optional[dict] = None
    ) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(data)

    def _read_body(self) -> dict:
        if not self._raw_body:
            return {}
        return json.loads(self._raw_body)

    def _route(self, method: str) -> None:
        url = urllib.parse.urlsplit(self.path)
        parts = [p for p in url.path.split("/") if p]
        query = dict(urllib.parse.parse_qsl(url.query))
        # Always drain the request body up front: a handler that ignores
        # it (e.g. the Eviction subresource) would otherwise leave bytes
        # in the socket and desync the next keep-alive request.
        length = int(self.headers.get("Content-Length", 0) or 0)
        self._raw_body = self.rfile.read(length) if length else b""
        if self.faults is not None and query.get("watch") != "true":
            # Unary fault check.  Watch requests are excluded here —
            # streams are dropped mid-flight by _stream_watch via
            # decide_watch_drop, not failed at establishment (a rule
            # matching "watch" would otherwise starve reconnects).
            fault = self.faults.decide(f"{method} {url.path}")
            if fault is not None and self._apply_fault(fault):
                return
        try:
            self._dispatch(method, parts, query)
        except NotFoundError as e:
            self._send(404, _status_body(404, "NotFound", str(e)))
        except ConflictError as e:
            # Real-apiserver reasons differ by verb: a create hitting an
            # existing name is AlreadyExists; an update losing the
            # resourceVersion CAS is Conflict ("the object has been
            # modified").  Both are HTTP 409.
            reason = "AlreadyExists" if method == "POST" else "Conflict"
            self._send(409, _status_body(409, reason, str(e)))
        except ExpiredError as e:
            # 410 Gone, reason Expired: a stale watch resourceVersion or
            # list continue token (post-compaction semantics).  Clients
            # re-list and resume.
            self._send(410, _status_body(410, "Expired", str(e)))
        except InvalidError as e:
            self._send(
                422,
                _status_body(
                    422,
                    "Invalid",
                    str(e),
                    causes=[
                        {"reason": "FieldValueInvalid", "message": c}
                        for c in e.causes
                    ],
                ),
            )
        except EvictionBlockedError as e:
            self._send(
                429,
                _status_body(
                    429,
                    "TooManyRequests",
                    f"Cannot evict pod as it would violate the pod's "
                    f"disruption budget: {e}",
                    causes=[{"reason": "DisruptionBudget", "message": str(e)}],
                ),
            )
        except ThrottledError as e:
            # Priority-and-fairness 429 (non-eviction): plain
            # TooManyRequests Status + Retry-After, no DisruptionBudget
            # cause — the client classifies on exactly that difference.
            self._send(
                429,
                _status_body(429, "TooManyRequests", str(e)),
                headers={"Retry-After": str(e.retry_after_s)},
            )
        except ServerError as e:
            self._send(
                e.status,
                _status_body(
                    e.status,
                    "ServiceUnavailable"
                    if e.status == 503
                    else "InternalError",
                    str(e),
                ),
            )
        except Exception as e:  # noqa: BLE001 — surface as 500, don't die
            logger.exception("apiserver handler error")
            self._send(
                500, _status_body(500, "InternalError", f"{type(e).__name__}: {e}")
            )

    def _apply_fault(self, fault: Fault) -> bool:
        """Synthesize the wire shape of an injected fault.  Returns True
        when the request was fully handled (response sent or connection
        doomed); False lets normal dispatch proceed."""
        if fault.kind == "throttle":
            self._send(
                429,
                _status_body(429, "TooManyRequests", fault.message),
                headers={"Retry-After": str(fault.retry_after_s)},
            )
            return True
        if fault.kind == "error":
            self._send(
                fault.status,
                _status_body(
                    fault.status,
                    "ServiceUnavailable"
                    if fault.status == 503
                    else "InternalError",
                    fault.message,
                ),
            )
            return True
        if fault.kind == "conflict":
            self._send(
                409, _status_body(409, "Conflict", fault.message)
            )
            return True
        if fault.kind in ("reset", "timeout"):
            if fault.kind == "timeout":
                # Stall past the client's timeout, in slices so server
                # shutdown isn't held hostage by an injected delay.
                deadline = time.monotonic() + fault.delay_s
                while (
                    time.monotonic() < deadline
                    and not self.stopping.is_set()
                ):
                    time.sleep(
                        min(0.05, max(0.0, deadline - time.monotonic()))
                    )
            # SO_LINGER(on, 0): the server's connection close becomes a
            # TCP RST — the client sees ConnectionResetError with no
            # HTTP response, the connection-level transient it must
            # classify and retry.  No response is written; the normal
            # close path (close_connection) delivers the reset.
            try:
                self.connection.setsockopt(
                    socket.SOL_SOCKET,
                    socket.SO_LINGER,
                    struct.pack("ii", 1, 0),
                )
            except OSError:
                pass
            self.close_connection = True
            return True
        return False  # watch_drop (or unknown): not a unary fault

    # -- dispatch -----------------------------------------------------------

    def _dispatch(self, method: str, parts: list[str], query: dict) -> None:
        label_selector = query.get("labelSelector", "")
        watching = query.get("watch") == "true"
        # watch?resourceVersion=N — resume point: retained history after
        # N replays first, or 410 when compacted away.  Absent = live
        # only.  (Divergence from k8s's legacy special-casing of "0" as
        # "any available point": here 0 is a genuine resume point, so the
        # wire tier and FakeCluster behave identically.)
        raw_rv = query.get("resourceVersion", "")
        self._since_rv = int(raw_rv) if raw_rv else None
        # allowWatchBookmarks=true: idle heartbeats may carry BOOKMARK
        # envelopes advancing the client's safe resume point.
        self._bookmarks = query.get("allowWatchBookmarks") == "true"
        # /api/v1/nodes[/{name}]
        if parts[:2] == ["api", "v1"] and len(parts) >= 3 and parts[2] == "nodes":
            if len(parts) == 3:
                if method == "GET" and watching:
                    return self._stream_watch(
                        ["Node"], node_to_json, label_selector=label_selector
                    )
                if method == "GET":
                    return self._paged_list(
                        "Node", "NodeList", "v1", node_to_json, "",
                        label_selector, query,
                    )
                return self._method_not_allowed(method, parts)
            name = parts[3]
            if method == "GET":
                return self._send(
                    200, node_to_json(self.store.get_node(name, cached=False))
                )
            if method == "PATCH":
                return self._patch_node(name)
            if method == "DELETE":
                self.store.delete_node(name)
                return self._send(
                    200, _status_body(200, "Success", "deleted")
                )
        # /api/v1/pods and /api/v1/namespaces/{ns}/pods[/{name}[/eviction]]
        if parts[:2] == ["api", "v1"]:
            # /api/v1/events — cluster-wide event list.
            if parts[2:] == ["events"] and method == "GET":
                field_selector = query.get("fieldSelector", "")
                involved = ""
                for clause in field_selector.split(","):
                    if clause.startswith("involvedObject.name="):
                        involved = clause.split("=", 1)[1]
                return self._send(
                    200,
                    {
                        "apiVersion": "v1",
                        "kind": "EventList",
                        "items": self.store.list_events(
                            involved_name=involved
                        ),
                    },
                )
            if parts[2:] == ["pods"] and method == "GET":
                if watching:
                    return self._stream_watch(
                        ["Pod"], pod_to_json, label_selector=label_selector
                    )
                return self._list_pods("", query)
            # /api/v1/namespaces/{ns}/events
            if (
                len(parts) == 5
                and parts[2] == "namespaces"
                and parts[4] == "events"
            ):
                ns = parts[3]
                if method == "POST":
                    created = self.store.create_event(ns, self._read_body())
                    return self._send(201, created)
                if method == "GET":
                    field_selector = query.get("fieldSelector", "")
                    involved = ""
                    for clause in field_selector.split(","):
                        if clause.startswith("involvedObject.name="):
                            involved = clause.split("=", 1)[1]
                    return self._send(
                        200,
                        {
                            "apiVersion": "v1",
                            "kind": "EventList",
                            "items": self.store.list_events(
                                namespace=ns, involved_name=involved
                            ),
                        },
                    )
                return self._method_not_allowed(method, parts)
            if len(parts) >= 5 and parts[2] == "namespaces" and parts[4] == "pods":
                ns = parts[3]
                if len(parts) == 5:
                    if method == "GET" and watching:
                        return self._stream_watch(
                            ["Pod"],
                            pod_to_json,
                            namespace=ns,
                            label_selector=label_selector,
                        )
                    if method == "GET":
                        return self._list_pods(ns, query)
                    return self._method_not_allowed(method, parts)
                name = parts[5]
                if len(parts) == 6 and method == "GET":
                    return self._send(
                        200, pod_to_json(self.store.get_pod(ns, name))
                    )
                if len(parts) == 6 and method == "DELETE":
                    grace = query.get("gracePeriodSeconds")
                    self.store.delete_pod(
                        ns,
                        name,
                        grace_period_seconds=(
                            int(grace) if grace is not None else None
                        ),
                    )
                    return self._send(
                        200, _status_body(200, "Success", "deleted")
                    )
                if (
                    len(parts) == 7
                    and parts[6] == "eviction"
                    and method == "POST"
                ):
                    self.store.evict_pod(ns, name)
                    return self._send(
                        201, _status_body(201, "Success", "evicted")
                    )
        # /apis/apps/v1/[namespaces/{ns}/]daemonsets|controllerrevisions
        if parts[:3] == ["apis", "apps", "v1"]:
            rest_parts = parts[3:]
            ns = ""
            if rest_parts[:1] == ["namespaces"]:
                ns = rest_parts[1]
                rest_parts = rest_parts[2:]
            if rest_parts == ["daemonsets"] and method == "GET" and watching:
                return self._stream_watch(
                    ["DaemonSet"],
                    daemon_set_to_json_full,
                    namespace=ns,
                    label_selector=label_selector,
                )
            if rest_parts[:1] == ["daemonsets"]:
                return self._daemonsets(method, ns, rest_parts[1:], query)
            if rest_parts[:1] == ["controllerrevisions"] and method == "GET":
                items = self.store.list_controller_revisions(
                    namespace=ns, label_selector=label_selector
                )
                return self._send(
                    200,
                    {
                        "apiVersion": "apps/v1",
                        "kind": "ControllerRevisionList",
                        "items": [
                            controller_revision_to_json(r) for r in items
                        ],
                    },
                )
        # /apis/{group}/{version}/namespaces/{ns}/{plural}[/{name}[/status]]
        # — custom resources (CRDs registered on the store).
        if parts[:1] == ["apis"] and len(parts) >= 6 and parts[3] == "namespaces":
            group, version, ns = parts[1], parts[2], parts[4]
            plural = parts[5]
            name = parts[6] if len(parts) >= 7 else None
            if name is None and method == "GET" and watching:
                # Validate the CRD is registered before streaming.
                self.store._custom_kind(group, version, plural)
                return self._stream_watch(
                    [plural], lambda obj: obj, namespace=ns
                )
            status_sub = len(parts) == 8 and parts[7] == "status"
            if len(parts) <= 7 or status_sub:
                return self._custom_objects(
                    method, group, version, plural, ns, name, status_sub
                )
        raise NotFoundError(f"no route for {method} {'/'.join(parts)}")

    # -- watch streaming ----------------------------------------------------

    @staticmethod
    def _event_meta(obj) -> tuple[str, dict]:
        """(namespace, labels) of a watch-event object, typed or dict."""
        if isinstance(obj, dict):
            meta = obj.get("metadata") or {}
            return meta.get("namespace", ""), meta.get("labels") or {}
        return obj.metadata.namespace or "", obj.metadata.labels

    def _stream_watch(
        self,
        kinds: list[str],
        to_json,
        namespace: str = "",
        label_selector: str = "",
    ) -> None:
        """Stream watch events as chunked JSON lines until the client
        goes away, in the real apiserver's envelope shape
        ``{"type": ..., "object": {...}}`` (the object carries its own
        kind), scoped by the request's namespace/labelSelector.  Blank
        lines are heartbeats (clients skip them).

        ``?resourceVersion=N`` (parsed in _dispatch) resumes from N:
        retained events after it replay first; a compacted-away N raises
        ExpiredError BEFORE headers are sent, so the client sees a plain
        410 Status and re-lists — the informer reconnect contract.
        Without a resume point there is no replay — clients pair watches
        with periodic resync, like controller-runtime informers."""
        sub = self.store.watch(kinds, since_rv=self._since_rv)
        bookmarked = self._since_rv or 0
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            while not self.stopping.is_set():
                if self.faults is not None and (
                    self.faults.decide_watch_drop(
                        "watch " + ",".join(kinds).lower()
                    )
                    is not None
                ):
                    # Injected drop: terminate the chunked body cleanly
                    # (below) so the client sees the stream close and
                    # runs its reconnect contract, exactly like a real
                    # apiserver timing out a watch.
                    break
                # Snapshot BEFORE the timed get (an empty queue over the
                # window proves every event <= snapshot was delivered, so
                # the snapshot is a safe BOOKMARK resume point).  Skipped
                # on non-bookmark streams — no store-lock traffic on the
                # default hot path.
                snapshot = (
                    self.store.current_resource_version()
                    if self._bookmarks
                    else 0
                )
                ev = sub.get(timeout_s=0.5)
                if ev is None:
                    if self._bookmarks and snapshot > bookmarked:
                        bookmarked = snapshot
                        for kind in kinds:
                            self._write_chunk(
                                json.dumps(
                                    {
                                        "type": "BOOKMARK",
                                        "object": {
                                            "kind": kind,
                                            "metadata": {
                                                "resourceVersion": str(
                                                    snapshot
                                                )
                                            },
                                        },
                                    }
                                ).encode()
                                + b"\n"
                            )
                        continue
                    self._write_chunk(b"\n")  # heartbeat / liveness probe
                    continue
                ns, labels = self._event_meta(ev.object)
                if namespace and ns and ns != namespace:
                    continue
                if label_selector and not matches_selector(
                    labels, label_selector
                ):
                    # Filtered out: NOT delivered, so it must not advance
                    # `bookmarked` — the next idle heartbeat then emits a
                    # BOOKMARK covering it (a real apiserver's bookmarks
                    # cover selector-filtered churn the same way).
                    continue
                if ev.rv:
                    bookmarked = max(bookmarked, ev.rv)
                line = (
                    json.dumps(
                        {"type": ev.type, "object": to_json(ev.object)}
                    ).encode()
                    + b"\n"
                )
                self._write_chunk(line)
            # Server stopping: end the chunked body properly so the
            # client observes a CLEAN stream close (and reconnects),
            # exactly like a real apiserver's watch request timeout.
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # client hung up
        finally:
            sub.close()
            self.close_connection = True

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _custom_objects(
        self,
        method: str,
        group: str,
        version: str,
        plural: str,
        ns: str,
        name: Optional[str],
        status_sub: bool = False,
    ) -> None:
        api_version = f"{group}/{version}"
        if name is None:
            if method == "GET":
                items = self.store.list_custom_objects(
                    group, version, plural, namespace=ns
                )
                return self._send(
                    200,
                    {
                        "apiVersion": api_version,
                        "kind": "List",
                        "items": items,
                    },
                )
            if method == "POST":
                created = self.store.create_custom_object(
                    group, version, plural, ns, self._read_body()
                )
                return self._send(201, created)
            return self._method_not_allowed(
                method, ["apis", group, version, "namespaces", ns, plural]
            )
        if method == "GET" and not status_sub:
            return self._send(
                200,
                self.store.get_custom_object(group, version, plural, ns, name),
            )
        if method == "PUT":
            body = self._read_body()
            # The URL owns the identity; a mismatched body name must not
            # silently retarget another object.
            body.setdefault("metadata", {})["name"] = name
            update = (
                self.store.update_custom_object_status
                if status_sub
                else self.store.update_custom_object
            )
            return self._send(
                200, update(group, version, plural, ns, body)
            )
        if method == "DELETE" and not status_sub:
            self.store.delete_custom_object(group, version, plural, ns, name)
            return self._send(200, _status_body(200, "Success", "deleted"))
        raise NotFoundError(f"no custom-resource route {method}")

    def _method_not_allowed(self, method: str, parts: list[str]) -> None:
        self._send(
            405,
            _status_body(
                405,
                "MethodNotAllowed",
                f"{method} is not supported on /{'/'.join(parts)}",
            ),
        )

    # -- verb implementations ------------------------------------------------

    def _patch_node(self, name: str) -> None:
        body = self._read_body()
        meta = body.get("metadata") or {}
        spec = body.get("spec") or {}
        node = None
        # Strategic-merge and JSON-merge coincide for flat string maps:
        # merge keys, null deletes (node_upgrade_state_provider.go:147's
        # "null" convention arrives here as real JSON null).
        if "labels" in meta:
            node = self.store.patch_node_labels(name, meta["labels"])
        if "annotations" in meta:
            node = self.store.patch_node_annotations(name, meta["annotations"])
        if "unschedulable" in spec:
            node = self.store.set_node_unschedulable(
                name, bool(spec["unschedulable"])
            )
        if node is None:
            # Patch touched nothing this server models: a real apiserver
            # applies the no-op merge and returns the object.
            node = self.store.get_node(name, cached=False)
        self._send(200, node_to_json(node))

    def _paged_list(
        self,
        kind: str,
        list_kind: str,
        api_version: str,
        to_json,
        namespace: str,
        label_selector: str,
        query: dict,
    ) -> None:
        """Chunked list (client-go pagination): ``?limit=N`` returns up
        to N items plus ``metadata.continue``; passing the token back
        serves the next chunk; an expired token 410s (handled in _route).
        The list envelope always carries ``metadata.resourceVersion`` —
        the watch resume point that bridges list → watch."""
        page = self.store.list_page(
            kind,
            namespace=namespace,
            label_selector=label_selector,
            limit=(int(query["limit"]) if query.get("limit") else None),
            continue_=query.get("continue") or None,
        )
        meta = {"resourceVersion": page["resourceVersion"]}
        if page["continue"]:
            meta["continue"] = page["continue"]
        self._send(
            200,
            {
                "apiVersion": api_version,
                "kind": list_kind,
                "metadata": meta,
                "items": [to_json(o) for o in page["items"]],
            },
        )

    def _list_pods(self, namespace: str, query: dict) -> None:
        field_selector = query.get("fieldSelector", "")
        node_name = None
        for clause in field_selector.split(","):
            if clause.startswith("spec.nodeName="):
                node_name = clause.split("=", 1)[1]
        if node_name is None and (query.get("limit") or query.get("continue")):
            # Chunked path (no fieldSelector composition needed by the
            # engine's pagers).
            return self._paged_list(
                "Pod", "PodList", "v1", pod_to_json, namespace,
                query.get("labelSelector", ""), query,
            )
        items = self.store.list_pods(
            namespace=namespace,
            label_selector=query.get("labelSelector", ""),
            node_name=node_name,
        )
        self._send(
            200,
            {
                "apiVersion": "v1",
                "kind": "PodList",
                "metadata": {
                    "resourceVersion": str(
                        self.store.current_resource_version()
                    )
                },
                "items": [pod_to_json(p) for p in items],
            },
        )

    def _daemonsets(
        self, method: str, ns: str, rest_parts: list[str], query: dict
    ) -> None:
        if not rest_parts:
            if method == "GET":
                # Full selector semantics (=, !=, in/notin, exists) via
                # the shared parser — a hand-rolled k=v split would
                # silently mis-parse negations.
                selector = query.get("labelSelector", "")
                items = [
                    ds
                    for ds in self.store.list_daemon_sets(namespace=ns)
                    if matches_selector(ds.metadata.labels, selector)
                ]
                return self._send(
                    200,
                    {
                        "apiVersion": "apps/v1",
                        "kind": "DaemonSetList",
                        "items": [daemon_set_to_json_full(d) for d in items],
                    },
                )
            if method == "POST":
                ds = daemon_set_from_json(self._read_body())
                ds.metadata.namespace = ds.metadata.namespace or ns
                created = self.store.create_daemon_set(ds)
                return self._send(201, daemon_set_to_json_full(created))
        else:
            name = rest_parts[0]
            if method == "GET":
                return self._send(
                    200,
                    daemon_set_to_json_full(self.store.get_daemon_set(ns, name)),
                )
            if method == "PUT":
                ds = daemon_set_from_json(self._read_body())
                ds.metadata.namespace = ds.metadata.namespace or ns
                ds.metadata.name = ds.metadata.name or name
                # Preserve identity/status across the wire update: the
                # client's update body intentionally omits server-owned
                # fields (uid, status), exactly like a real apiserver
                # merges them.
                current = self.store.get_daemon_set(ns, name)
                ds.metadata.uid = current.metadata.uid
                ds.status = current.status
                updated = self.store.update_daemon_set(ds)
                return self._send(200, daemon_set_to_json_full(updated))
        raise NotFoundError(f"no daemonset route {method} {rest_parts}")

    # -- stdlib verb entrypoints ---------------------------------------------

    def do_GET(self) -> None:  # noqa: N802
        self._route("GET")

    def do_POST(self) -> None:  # noqa: N802
        self._route("POST")

    def do_PUT(self) -> None:  # noqa: N802
        self._route("PUT")

    def do_PATCH(self) -> None:  # noqa: N802
        self._route("PATCH")

    def do_DELETE(self) -> None:  # noqa: N802
        self._route("DELETE")


class KubeApiServer:
    """A threaded HTTP apiserver over a FakeCluster object store.

    The store is constructed with zero injected latency/cache-lag: a REST
    read against a real apiserver is a quorum read, and the engine's
    write-then-poll cache loop must converge on the first poll
    (rest.RestClient.get_node notes the same).
    """

    def __init__(
        self,
        store: Optional[FakeCluster] = None,
        port: int = 0,
        fault_schedule: Optional[FaultSchedule] = None,
    ):
        self.store = store if store is not None else FakeCluster()
        self._stopping = threading.Event()
        self._handler_cls = type(
            "BoundHandler",
            (_Handler,),
            {
                "store": self.store,
                "stopping": self._stopping,
                "faults": fault_schedule,
            },
        )
        self._httpd = ThreadingHTTPServer(
            ("127.0.0.1", port), self._handler_cls
        )
        self._thread: Optional[threading.Thread] = None

    @property
    def fault_schedule(self) -> Optional[FaultSchedule]:
        return self._handler_cls.faults

    @fault_schedule.setter
    def fault_schedule(self, schedule: Optional[FaultSchedule]) -> None:
        # Class-attr swap: takes effect for in-flight handler threads'
        # next request/iteration too (they read self.faults each time).
        self._handler_cls.faults = schedule

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def host(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "KubeApiServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        # Terminate open watch streams first (their handler threads
        # outlive shutdown(), which only stops the accept loop).
        self._stopping.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)

    def __enter__(self) -> "KubeApiServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
