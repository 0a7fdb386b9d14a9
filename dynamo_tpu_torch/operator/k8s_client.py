"""Minimal Kubernetes REST client (stdlib only); the port's copy of
`dynamo_tpu/operator/k8s_client.py` (keep the two in step).

The reference consumes a Go operator (controller-manager waited on at
reference install-dynamo-1node.sh:244-245). Our operator is Python, so
it needs a K8s API client; rather than depending on the kubernetes package
(not in the baked image), this speaks the REST API directly over urllib —
enough surface for the reconciler: namespaced CRUD + list with labelSelector
+ JSON merge-patch + status subresource.

Auth: in-cluster service-account token + CA (the standard
/var/run/secrets/kubernetes.io/serviceaccount mount), or an explicit
base_url/token (used by tests against the in-process fake API server).
"""

from __future__ import annotations

import json
import os
import ssl
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class ApiError(Exception):
    def __init__(self, status: int, reason: str, body: str = ""):
        super().__init__(f"{status} {reason}: {body[:200]}")
        self.status = status
        self.reason = reason
        self.body = body

    @property
    def not_found(self) -> bool:
        return self.status == 404

    @property
    def conflict(self) -> bool:
        return self.status == 409


def resource_path(
    api_version: str, plural: str, namespace: Optional[str], name: Optional[str] = None
) -> str:
    """Build a K8s REST path: core group -> /api/v1, others -> /apis/g/v."""
    base = f"/api/{api_version}" if "/" not in api_version else f"/apis/{api_version}"
    if namespace:
        base += f"/namespaces/{namespace}"
    base += f"/{plural}"
    if name:
        base += f"/{name}"
    return base


class K8sClient:
    def __init__(
        self,
        base_url: str,
        token: Optional[str] = None,
        ca_file: Optional[str] = None,
        insecure: bool = False,
        timeout: float = 30.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout = timeout
        if base_url.startswith("https"):
            if insecure:
                self._ctx: Optional[ssl.SSLContext] = ssl._create_unverified_context()
            else:
                self._ctx = ssl.create_default_context(cafile=ca_file)
        else:
            self._ctx = None

    @classmethod
    def in_cluster(cls) -> "K8sClient":
        host = os.environ["KUBERNETES_SERVICE_HOST"]
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        with open(f"{SA_DIR}/token") as f:
            token = f.read().strip()
        return cls(f"https://{host}:{port}", token=token, ca_file=f"{SA_DIR}/ca.crt")

    @classmethod
    def from_env(cls) -> "K8sClient":
        """KUBE_API_URL override (tests / kubectl proxy), else in-cluster."""
        url = os.environ.get("KUBE_API_URL")
        if url:
            return cls(url, token=os.environ.get("KUBE_API_TOKEN"))
        return cls.in_cluster()

    # ------------------------------------------------------------- raw HTTP --
    def _request(
        self,
        method: str,
        path: str,
        body: Optional[Dict[str, Any]] = None,
        content_type: str = "application/json",
        params: Optional[Dict[str, str]] = None,
    ) -> Dict[str, Any]:
        url = self.base_url + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout, context=self._ctx) as r:
                text = r.read().decode()
        except urllib.error.HTTPError as e:
            raise ApiError(e.code, e.reason, e.read().decode(errors="replace")) from None
        return json.loads(text) if text else {}

    # ----------------------------------------------------------------- CRUD --
    def list(
        self,
        api_version: str,
        plural: str,
        namespace: Optional[str] = None,
        label_selector: Optional[str] = None,
    ) -> List[Dict[str, Any]]:
        return self.list_with_rv(api_version, plural, namespace,
                                 label_selector)[0]

    def list_with_rv(
        self,
        api_version: str,
        plural: str,
        namespace: Optional[str] = None,
        label_selector: Optional[str] = None,
    ) -> tuple:
        """List plus the collection resourceVersion — the token a subsequent
        watch() resumes from (the informer list-then-watch handshake)."""
        params = {"labelSelector": label_selector} if label_selector else None
        out = self._request(
            "GET", resource_path(api_version, plural, namespace), params=params
        )
        rv = (out.get("metadata") or {}).get("resourceVersion") or "0"
        return out.get("items", []), rv

    def watch(
        self,
        api_version: str,
        plural: str,
        namespace: Optional[str] = None,
        resource_version: str = "0",
        timeout_s: float = 60.0,
        label_selector: Optional[str] = None,
    ):
        """Yield watch events ({"type": ..., "object": ...}) after
        `resource_version` until the server closes the stream (bounded by
        timeoutSeconds, the apiserver contract). Raises ApiError(410) when
        the version is too old — the caller must relist and re-watch."""
        params = {
            "watch": "true",
            "resourceVersion": str(resource_version),
            "timeoutSeconds": str(int(timeout_s)),
        }
        if label_selector:
            params["labelSelector"] = label_selector
        url = (self.base_url + resource_path(api_version, plural, namespace)
               + "?" + urllib.parse.urlencode(params))
        req = urllib.request.Request(url, method="GET")
        req.add_header("Accept", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            # read timeout a bit past the server-side bound so a healthy
            # stream is always closed by the server, not the socket
            with urllib.request.urlopen(
                req, timeout=timeout_s + 15.0, context=self._ctx
            ) as r:
                for raw in r:
                    line = raw.strip()
                    if not line:
                        continue
                    try:
                        yield json.loads(line)
                    except json.JSONDecodeError:
                        continue  # truncated tail line at stream close
        except urllib.error.HTTPError as e:
            raise ApiError(
                e.code, e.reason, e.read().decode(errors="replace")
            ) from None

    def get(
        self, api_version: str, plural: str, namespace: Optional[str], name: str
    ) -> Dict[str, Any]:
        return self._request("GET", resource_path(api_version, plural, namespace, name))

    def create(
        self, api_version: str, plural: str, namespace: Optional[str], obj: Dict[str, Any]
    ) -> Dict[str, Any]:
        return self._request(
            "POST", resource_path(api_version, plural, namespace), body=obj
        )

    def replace(
        self, api_version: str, plural: str, namespace: Optional[str], name: str,
        obj: Dict[str, Any],
    ) -> Dict[str, Any]:
        return self._request(
            "PUT", resource_path(api_version, plural, namespace, name), body=obj
        )

    def merge_patch(
        self, api_version: str, plural: str, namespace: Optional[str], name: str,
        patch: Dict[str, Any],
    ) -> Dict[str, Any]:
        return self._request(
            "PATCH",
            resource_path(api_version, plural, namespace, name),
            body=patch,
            content_type="application/merge-patch+json",
        )

    def patch_status(
        self, api_version: str, plural: str, namespace: Optional[str], name: str,
        status: Dict[str, Any],
    ) -> Dict[str, Any]:
        return self._request(
            "PATCH",
            resource_path(api_version, plural, namespace, name) + "/status",
            body={"status": status},
            content_type="application/merge-patch+json",
        )

    def delete(
        self, api_version: str, plural: str, namespace: Optional[str],
        name: str, propagation: Optional[str] = None,
    ) -> None:
        """propagation: cascade policy ("Background"/"Foreground"). Raw API
        deletes of batch/v1 Jobs default to ORPHANING their pods (kubectl
        sets Background itself) — Job callers must pass it explicitly."""
        body = None
        if propagation:
            body = {"kind": "DeleteOptions", "apiVersion": "v1",
                    "propagationPolicy": propagation}
        try:
            self._request(
                "DELETE", resource_path(api_version, plural, namespace, name),
                body=body,
            )
        except ApiError as e:
            if not e.not_found:
                raise

    def upsert(
        self, api_version: str, plural: str, namespace: Optional[str], obj: Dict[str, Any]
    ) -> Dict[str, Any]:
        """Create, or merge-patch the spec/labels onto an existing object."""
        name = obj["metadata"]["name"]
        try:
            return self.create(api_version, plural, namespace, obj)
        except ApiError as e:
            if not e.conflict:
                raise
            return self.merge_patch(api_version, plural, namespace, name, obj)
