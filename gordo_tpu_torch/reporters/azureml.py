"""
An AzureML workspace's MLflow tracking server, reached through a service
principal without the AzureML SDK: the port of the JAX reporter's
``Workspace(..., auth=ServicePrincipalAuthentication(...))
.get_mlflow_tracking_uri()`` and the ``azureml-mlflow`` plugin's client.

1. The service principal's token: OAuth2's client-credentials grant,
   ``POST <login host>/<tenant_id>/oauth2/v2.0/token`` with
   ``client_id``, ``client_secret`` and the scope
   ``https://management.azure.com/.default`` (the Microsoft identity
   platform's "OAuth 2.0 client credentials flow"), fetched again once it
   has expired (:data:`EXPIRY_MARGIN_S` early), since a fleet's reports
   can outlast it.
2. The workspace: ``GET <ARM host>/subscriptions/<sub>/resourceGroups/
   <rg>/providers/Microsoft.MachineLearningServices/workspaces/<ws>
   ?api-version=2023-04-01`` (the Azure REST API reference, Machine
   Learning, "Workspaces - Get"), with the token as a Bearer. Its
   ``properties.mlFlowTrackingUri`` is the tracking URI; without it, the
   URI the SDK builds from the workspace's region,
   ``azureml://<location>.api.azureml.ms/mlflow/v1.0/subscriptions/...``.
3. The ``azureml://`` URI as ``azureml-mlflow`` maps it: ``https://``
   with the same host and path, the MLflow REST API under it, each
   request with the same Bearer token (:class:`RestTrackingClient`).

The public cloud's hosts are :data:`LOGIN_HOST` and :data:`ARM_HOST`;
tests and ``chip_smoke.py`` pass a stub's instead
(``reporters/mlflowstub.py``, built to the same description: the tests
prove the two agree, not that Azure does). TLS follows the tracking
client's settings (``mlflow_rest.tls_context``).

Where ``DL_SERVICE_AUTH_STR`` is unset or empty the JAX reporter falls
back to ``InteractiveLoginAuthentication(force=True)``, a browser login;
a pod has no browser, so this raises :class:`MlflowLoggingError` instead.
"""

import json
import time
import urllib.parse
from typing import Callable, Optional

from .mlflow_rest import MlflowLoggingError, RestTrackingClient, http_request

LOGIN_HOST = "https://login.microsoftonline.com"
ARM_HOST = "https://management.azure.com"
ARM_SCOPE = "https://management.azure.com/.default"
API_VERSION = "2023-04-01"
#: a token is fetched again this long before its stated expiry
EXPIRY_MARGIN_S = 60.0
WORKSPACE_KEYS = ["subscription_id", "resource_group", "workspace_name"]
SERVICE_PRINCIPAL_KEYS = ["tenant_id", "service_principal_id", "service_principal_password"]


class ServicePrincipalToken:
    """A callable giving ``Bearer <token>`` of a service principal's ARM
    token, fetched at first use and again once it has expired."""

    def __init__(self, tenant_id: str, service_principal_id: str, service_principal_password: str,
                 login_host: str = LOGIN_HOST):
        self.url = f"{login_host.rstrip('/')}/{urllib.parse.quote(tenant_id, safe='')}/oauth2/v2.0/token"
        self.form = urllib.parse.urlencode({"grant_type": "client_credentials", "client_id": service_principal_id,
                                            "client_secret": service_principal_password,
                                            "scope": ARM_SCOPE}).encode()
        self.token: Optional[str] = None
        self.expires_at = 0.0

    def __call__(self) -> str:
        if self.token is None or time.monotonic() >= self.expires_at:
            answer = json.loads(http_request("POST", self.url, self.form,
                                             {"Content-Type": "application/x-www-form-urlencoded"}))
            if not answer.get("access_token"):
                raise MlflowLoggingError(f"POST {self.url}: the answer holds no access_token")
            self.token = answer["access_token"]
            self.expires_at = time.monotonic() + float(answer.get("expires_in", 0)) - EXPIRY_MARGIN_S
        return f"Bearer {self.token}"


def workspace_scope(subscription_id: str, resource_group: str, workspace_name: str) -> str:
    """The workspace's ARM resource path."""
    sub, group, name = (urllib.parse.quote(v, safe="") for v in (subscription_id, resource_group, workspace_name))
    return f"/subscriptions/{sub}/resourceGroups/{group}/providers/Microsoft.MachineLearningServices/workspaces/{name}"


def workspace_tracking_uri(workspace_kwargs: dict, authorization: Callable[[], str], arm_host: str = ARM_HOST) -> str:
    """The workspace's ``azureml://`` tracking URI, read from ARM."""
    scope = workspace_scope(**{k: workspace_kwargs[k] for k in WORKSPACE_KEYS})
    answer = http_request("GET", f"{arm_host.rstrip('/')}{scope}?api-version={API_VERSION}",
                          headers={"Authorization": authorization()})
    workspace = json.loads(answer)
    uri = (workspace.get("properties") or {}).get("mlFlowTrackingUri")
    if uri:
        return uri
    if not workspace.get("location"):
        raise MlflowLoggingError(f"the workspace {scope} has neither properties.mlFlowTrackingUri nor a location")
    return f"azureml://{workspace['location']}.api.azureml.ms/mlflow/v1.0{scope}"


def rest_uri(tracking_uri: str) -> str:
    """An ``azureml://`` tracking URI as the ``https://`` base of its REST
    API."""
    parts = urllib.parse.urlsplit(tracking_uri)
    if parts.scheme != "azureml":
        raise MlflowLoggingError(f"the workspace's tracking URI {tracking_uri!r} is not an azureml:// URI")
    return f"https://{parts.netloc}{parts.path}"


def workspace_client(workspace_kwargs: dict, service_principal_kwargs: dict, login_host: str = LOGIN_HOST,
                     arm_host: str = ARM_HOST) -> RestTrackingClient:
    """The REST client of the workspace's tracking server, authenticated
    as the service principal."""
    missing = [k for k in WORKSPACE_KEYS if k not in workspace_kwargs]
    if missing:
        raise MlflowLoggingError(f"Missing keys {missing} in workspace kwargs")
    if not service_principal_kwargs:
        raise MlflowLoggingError(
            "remote AzureML tracking needs DL_SERVICE_AUTH_STR (tenant_id:service_principal_id:"
            "service_principal_password): the interactive login the JAX reporter falls back to needs a browser, "
            "which a pod does not have")
    missing = [k for k in SERVICE_PRINCIPAL_KEYS if k not in service_principal_kwargs]
    if missing:
        raise MlflowLoggingError(f"Missing keys {missing} in service principal kwargs")
    token = ServicePrincipalToken(**{k: service_principal_kwargs[k] for k in SERVICE_PRINCIPAL_KEYS},
                                  login_host=login_host)
    return RestTrackingClient(rest_uri(workspace_tracking_uri(workspace_kwargs, token, arm_host)),
                              authorization=token)
